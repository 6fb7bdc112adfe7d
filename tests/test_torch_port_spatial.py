"""yolosomi_tpu_torch's spatial sharding (parallel/spatial.py and its
wiring) against the unsharded port and the JAX package's
Runner(spatial_shards=2), on the CPU.

The invariant: a batch served over S H-strips, one a rank, gives the
unsharded result. Every operator that looks across rows gets its halo
rows or its whole-map reduction from the other strips, so each one is
held to the same module on the whole map (f32, atol 1e-5) at S = 2 and 3,
and the whole models' head maps to the unsharded Runner's within 1e-4
with the same kept detections. The JAX package runs its sharded Runner on
conftest.py's eight virtual CPU devices (a 4 x 2 mesh, so a batch of 4),
held at the limit that the port's unsharded Runner keeps to JAX's
unsharded one at this size (ROW_BOX_TOL, ROW_SCORE_TOL: the entry tests'
ROWS_TOL is for 64 px and x5 norm scales), both asserted.

The port's ranks are processes spawned by parallel.mesh.spawn_local over
gloo with one thread each; their functions live in
tests/_torch_parallel_ranks.py, which imports no jax. One spawn a world
size runs every rank-side case of that size.

Sizes: the flagship and yolo-somi-dcn (random offset heads, samples
crossing strips), BatchNorm scales spread (GAIN), at width
0.25, depth 0.33, 256 px; the flagship at S = 3 over 320 px (strips of
128 / 96 / 96 rows); a 2 x 2 mesh (two batch slices of two strips);
yolov3-tiny (its pad and stride-1 pool across the strips' seam) and the
flagship's TTA (canvases of 256, 224 and 192 px, each split in two) at
S = 2.
"""

import functools
import logging

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from tests import _torch_parallel_ranks as ranks
from tests._torch_port_common import few_threads, jax_flagship, jax_random_model, small_flagship_cfg  # noqa: F401
from tests._torch_port_common import DEPTH, WIDTH
from tests.test_torch_port_checkpoint import spread
from tests.test_torch_port_eval import _write_image
from yolosomi_tpu.engine import checkpoint as jax_ckpt
from yolosomi_tpu.engine import runner as jax_runner_mod
from yolosomi_tpu.utils.config import find_config, load_model_cfg
from yolosomi_tpu_torch import detect, val
from yolosomi_tpu_torch.data.datasets import DataLoader, DetectionDataset
from yolosomi_tpu_torch.engine.runner import Runner, attempt_load
from yolosomi_tpu_torch.ops.dcn import dcnv2_im2col_reference, dcnv3_core_reference
from yolosomi_tpu_torch.parallel.mesh import spawn_local
from yolosomi_tpu_torch.parallel.spatial import strip_plan
from yolosomi_tpu_torch.utils.boxes import scale_coords, xyxy2xywhn

NC, SIZE, BATCH = 3, 256, 4
# BatchNorm scales x10: at 256 px the x5 of the entry tests leaves hundreds
# of scores within 1e-3 of 0.29, which no f32 reordering keeps apart; at
# x10 the flagship's and yolo-somi-dcn's scores above CONF spread over
# 0.5-0.9, tens of rows an image, the max_det cap unreached
GAIN, CONF = 10.0, 0.5
HEAD_TOL = 1e-4  # sharded head maps against the unsharded Runner's (f32)
# (B, 300, 6) rows in f32, boxes in pixels and scores: at 256 px and GAIN
# the port's unsharded rows lie up to 5.8e-3 px and 7.7e-6 from JAX's
# unsharded ones, JAX's sharded rows as far from its unsharded ones, and
# the port's sharded rows 3.7e-3 px and 2.8e-6 from its unsharded ones (a
# box decodes a head output's rounding times up to 8 x its anchor, 235 px
# at P5); both comparisons with JAX hold this limit
ROW_BOX_TOL, ROW_SCORE_TOL = 1e-2, 2e-5
OP_TOL = 1e-5  # one operator on strips against the whole map (f32)
OPERATORS = ("conv3_s1", "conv3_s2", "conv6_s2_p2", "conv3x1", "focus", "contract", "sppf_negative", "spp_negative",
             "cbam", "seam", "ema_cbam", "odconv", "dcnv2", "dcnv3", "maxpool_k2s2", "maxpool_k3s2p1",
             "zeropad_maxpool", "ghost_s2", "c3ghost", "c3tr", "scdown", "c2fcib_lk", "psa", "classify")
# yolov3-tiny's threshold: at GAIN its scores crowd 0.5-0.62 (~270 rows an
# image above 0.5, the nearest 2e-5 from it); above 0.55 ~210 rows, none
# within 7e-4 of it
TINY_CONF = 0.55


def _images(n: int, size: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """Weights files written by the JAX package: the small flagship and the
    small yolo-somi-dcn (random variables, its offset heads among them),
    their BatchNorm scales spread by GAIN, with their configs."""
    d = tmp_path_factory.mktemp("spatial")
    out = {}
    for name, cfg in (("flagship", small_flagship_cfg()), ("dcn", _small("yolo-somi-dcn")),
                      ("tiny", _small("hub/yolov3-tiny"))):
        cfg_path = d / f"{name}.yaml"
        cfg_path.write_text(yaml.safe_dump(cfg))
        _, meta, variables = jax_flagship(cfg) if name == "flagship" else jax_random_model(cfg)
        variables = spread(variables, GAIN)
        weights = d / f"{name}.msgpack"
        jax_ckpt.save_variables(str(weights), variables, anchors=meta.anchors_px.astype(np.float32))
        out[name] = dict(cfg=str(cfg_path), weights=str(weights))
    return out


def _small(name: str) -> dict:
    cfg = dict(load_model_cfg(find_config(name)))
    cfg["width_multiple"], cfg["depth_multiple"] = WIDTH, DEPTH
    return cfg


@pytest.fixture(scope="module")
def data(models, tmp_path_factory):
    """Six synthetic images labelled with the unsharded port's top 3
    detections each (conf > CONF), as a data dict for val.run."""
    root = tmp_path_factory.mktemp("spatial-set")
    (root / "images").mkdir()
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(256, 256), (200, 256), (256, 180), (240, 240), (160, 256), (256, 256)]):
        _write_image(root / "images" / f"im{i}.png", rng, h, w)
    runner = Runner(models["flagship"]["cfg"], models["flagship"]["weights"], dtype=torch.float32, device="cpu")
    for images, _, paths, shapes in DataLoader(DetectionDataset(str(root / "images"), img_size=SIZE), 2):
        for det, path, ((h0, w0), ratio_pad) in zip(runner(images, conf_thres=CONF), paths, shapes):
            det = det[det[:, 4] > 0][:3]
            xywhn = xyxy2xywhn(scale_coords(images.shape[1:3], det[:, :4], (h0, w0), ratio_pad), w=w0, h=h0)
            (root / "labels" / (path.rsplit("/", 1)[-1].rsplit(".", 1)[0] + ".txt")).write_text(
                "".join(f"{int(c)} " + " ".join(f"{v:.6f}" for v in b) + "\n" for c, b in zip(det[:, 5], xywhn)))
    return {"path": str(root), "val": str(root / "images"), "nc": NC, "names": ["a", "b", "c"]}


@pytest.fixture(scope="module")
def world2(models, data, tmp_path_factory):
    """Two ranks, two strips: the operator cases, the three models' Runner,
    the flagship's TTA, and the entry points."""
    project = tmp_path_factory.mktemp("spatial-runs")
    calls = [(ranks.spatial_operators, dict(names=list(OPERATORS))),
             (ranks.spatial_runner, dict(cfg=models["flagship"]["cfg"], weights=models["flagship"]["weights"],
                                         images=_images(BATCH, SIZE, 1), shards=2, conf=CONF)),
             (ranks.spatial_runner, dict(cfg=models["dcn"]["cfg"], weights=models["dcn"]["weights"],
                                         images=_images(BATCH, SIZE, 2), shards=2, conf=CONF)),
             (ranks.spatial_entry_points, dict(cfg=models["flagship"]["cfg"],
                                               weights=[models["flagship"]["weights"]] * 2,
                                               data=data, source=data["val"], project=str(project), conf=CONF)),
             (ranks.spatial_runner, dict(cfg=models["tiny"]["cfg"], weights=models["tiny"]["weights"],
                                         images=_images(BATCH, SIZE, 4), shards=2, conf=TINY_CONF)),
             (ranks.spatial_runner, dict(cfg=models["flagship"]["cfg"], weights=models["flagship"]["weights"],
                                         images=_images(BATCH, SIZE, 5), shards=2, conf=CONF, augment=True))]
    return spawn_local(2, ranks.run_calls, calls, timeout=600)


@pytest.fixture(scope="module")
def world3(models):
    """Three ranks, three strips: the operator cases, and the flagship over
    320 px (strips of 128 / 96 / 96 rows)."""
    calls = [(ranks.spatial_operators, dict(names=list(OPERATORS))),
             (ranks.spatial_runner, dict(cfg=models["flagship"]["cfg"], weights=models["flagship"]["weights"],
                                         images=_images(2, 320, 3), shards=3, conf=CONF)),
             (ranks.spatial_refusals, dict(cfg=models["flagship"]["cfg"], weights=models["flagship"]["weights"],
                                           cases=[(3, (1, SIZE)), (3, (1, 330)), (2, (1, SIZE))]))]
    return spawn_local(3, ranks.run_calls, calls, timeout=600)


@pytest.fixture(scope="module")
def world4(models):
    """Four ranks as a 2 x 2 mesh: two batch slices, each over two strips."""
    calls = [(ranks.spatial_runner, dict(cfg=models["flagship"]["cfg"], weights=models["flagship"]["weights"],
                                         images=_images(BATCH, SIZE, 1), shards=2, conf=CONF)),
             (ranks.spatial_refusals, dict(cfg=models["flagship"]["cfg"], weights=models["flagship"]["weights"],
                                           cases=[(2, (3, SIZE))]))]
    return spawn_local(4, ranks.run_calls, calls, timeout=600)


def assert_same_kept_set(got: np.ndarray, want: np.ndarray) -> None:
    """The same (B, max_det, 6) detections kept, in any order: for every
    image the same number of valid rows, each matched by one row of the
    other with its class, its box within ROW_BOX_TOL and its score within
    ROW_SCORE_TOL (rounding apart may sort near-equal scores apart)."""
    assert got.shape == want.shape
    for b in range(len(got)):
        ranks.match_rows(got[b][got[b][:, 4] > 0], want[b][want[b][:, 4] > 0], [ROW_BOX_TOL] * 4 + [ROW_SCORE_TOL])


def _unsharded(model: dict, images: np.ndarray, conf: float = CONF, augment: bool = False):
    runner = Runner(model["cfg"], model["weights"], dtype=torch.float32, device="cpu")
    return [p.numpy() for p in runner.forward(images)], runner(images, conf_thres=conf, augment=augment)


# ---------------------------------------------------------------------------
# the strip plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("height, shards, unit, bounds", [
    (256, 2, 32, (0, 128, 256)), (256, 3, 32, (0, 96, 192, 256)), (320, 3, 32, (0, 128, 224, 320)),
    (1280, 2, 32, (0, 640, 1280)), (1280, 4, 64, (0, 320, 640, 960, 1280)), (28, 3, 4, (0, 12, 20, 28))])
def test_strip_plan_splits_at_the_models_stride(height, shards, unit, bounds):
    plan = strip_plan(height, shards, unit, halo=1)
    assert plan.bounds == bounds and plan.shards == shards
    assert all(b % unit == 0 for b in plan.bounds)


@pytest.mark.parametrize("height, shards, unit, halo, match", [
    (250, 2, 32, 1, "multiples of the model's stride"), (64, 3, 32, 1, "fewer than the largest halo"),
    (256, 3, 32, 3, "fewer than the largest halo"), (256, 2, 32, 5, "fewer than the largest halo")],
    ids=["stride", "units", "halo-S3", "halo-S2"])
def test_strip_plan_refuses_a_bad_split(height, shards, unit, halo, match):
    with pytest.raises(ValueError, match=match):
        strip_plan(height, shards, unit, halo)


def test_sharded_runner_needs_a_process_group(models):
    """Never unsharded quietly: without a group the Runner names torchrun."""
    with pytest.raises(RuntimeError, match="torchrun"):
        Runner(models["flagship"]["cfg"], models["flagship"]["weights"], device="cpu", spatial_shards=2)


@pytest.mark.parametrize("world, case", [(3, 0), (3, 1), (3, 2), (4, 3)],
                         ids=["halo-S3", "off-stride", "W-by-S", "B-by-D"])
def test_sharded_runner_refuses_a_bad_split(world3, world4, world, case):
    """The flagship asks 3 halo rows at stride 32 (CBAM's 7x7 gate), so 256
    px over 3 strips (2 rows at the coarsest level) is refused, as are an
    image height off the stride, 3 ranks for 2 strips, and a batch of 3
    over 2 batch slices."""
    msgs = world3[0][2] if world == 3 else world4[0][1]
    match = ("fewer than the largest halo", "multiples of the model's stride", "do not divide a world",
             "does not split")[case]
    assert match in msgs[case if world == 3 else 0], msgs


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", OPERATORS)
@pytest.mark.parametrize("shards", [2, 3])
def test_operator_on_strips_equals_the_whole_map(world2, world3, shards, name):
    module, x = ranks.spatial_case(name)
    with torch.no_grad():
        want = module(x).numpy()
    for rank in (world2 if shards == 2 else world3):
        got = rank[0][name]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=OP_TOL, err_msg=name)


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("row0", [1, 5])
def test_dcnv2_plain_row0_is_the_whole_calls_rows(stride, row0):
    rng = np.random.default_rng(row0 + 10 * stride)
    x = torch.from_numpy(rng.standard_normal((2, 14, 10, 8)).astype(np.float32))
    ho, wo = (14 - 1) // stride + 1, (10 - 1) // stride + 1
    off_y, off_x = (torch.from_numpy(3 * rng.standard_normal((2, ho, wo, 9)).astype(np.float32)) for _ in range(2))
    mask = torch.from_numpy(rng.random((2, ho, wo, 9)).astype(np.float32))
    whole = dcnv2_im2col_reference(x, off_y, off_x, mask, 3, stride, 1).reshape(2, ho, wo, -1)
    part = dcnv2_im2col_reference(x, off_y[:, row0:].contiguous(), off_x[:, row0:].contiguous(),
                                  mask[:, row0:].contiguous(), 3, stride, 1, row0=row0)
    np.testing.assert_array_equal(part.reshape(2, ho - row0, wo, -1).numpy(), whole[:, row0:].numpy())


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("row0", [1, 6])
def test_dcnv3_plain_row0_is_the_whole_calls_rows(k, row0):
    rng = np.random.default_rng(row0 + 10 * k)
    g, cg, p = 2, 4, k * k
    x = torch.from_numpy(rng.standard_normal((2, 12, 10, g * cg)).astype(np.float32))
    off = torch.from_numpy(3 * rng.standard_normal((2, 12, 10, g * p * 2)).astype(np.float32))
    mask = torch.softmax(torch.from_numpy(rng.standard_normal((2, 12, 10, g, p)).astype(np.float32)), -1)
    mask = mask.reshape(2, 12, 10, g * p)
    args = (k, k, 1, 1, k // 2, k // 2, 1, 1, g, cg)
    whole = dcnv3_core_reference(x, off, mask, *args)
    part = dcnv3_core_reference(x, off[:, row0:row0 + 4].contiguous(), mask[:, row0:row0 + 4].contiguous(), *args,
                                row0=row0)
    np.testing.assert_array_equal(part.numpy(), whole[:, row0:row0 + 4].numpy())


# ---------------------------------------------------------------------------
# the Runner and the entry points
# ---------------------------------------------------------------------------


def _runner_case(world2, world3, world4, case):
    """(model name, global batch, every rank's result) of one Runner case."""
    if case == "flagship":
        return "flagship", _images(BATCH, SIZE, 1), [r[1] for r in world2]
    if case == "dcn":
        return "dcn", _images(BATCH, SIZE, 2), [r[2] for r in world2]
    if case == "tiny":
        return "tiny", _images(BATCH, SIZE, 4), [r[4] for r in world2]
    if case == "flagship-tta":
        return "flagship", _images(BATCH, SIZE, 5), [r[5] for r in world2]
    if case == "flagship-S3":
        return "flagship", _images(2, 320, 3), [r[1] for r in world3]
    return "flagship", _images(BATCH, SIZE, 1), [r[0] for r in world4]


@pytest.mark.parametrize("case", ["flagship", "dcn", "flagship-S3", "flagship-2x2", "tiny", "flagship-tta"])
def test_sharded_runner_equals_the_unsharded_runner(models, world2, world3, world4, case):
    """Head maps of a plain forward, and rows: TTA's for flagship-tta (its
    three canvases each split in two; `exchange` sums theirs)."""
    name, images, results = _runner_case(world2, world3, world4, case)
    preds, out = _unsharded(models[name], images, TINY_CONF if case == "tiny" else CONF, case == "flagship-tta")
    for r in results:
        assert [p.shape for p in r["preds"]] == [p.shape for p in preds]
        for got, want in zip(r["preds"], preds):
            np.testing.assert_allclose(got, want, rtol=0, atol=HEAD_TOL)
        assert_same_kept_set(r["out"], out)
        np.testing.assert_array_equal(r["out"], results[0]["out"])  # the whole result, the same on every rank
    assert [r["strip"] for r in results] == [i % len({r["strip"] for r in results}) for i in range(len(results))]
    assert all(r["exchange"]["halo_bytes"] > 0 and r["exchange"]["output_bytes"] > 0 for r in results)


@pytest.mark.parametrize("case", ["flagship", "dcn"])
def test_sharded_runner_equals_jax_sharded(models, world2, case):
    """JAX's Runner(spatial_shards=2) on a 4 x 2 mesh of the eight virtual
    devices, the batch of 4 split over 'data' and H over 'model', against
    the port's sharded Runner, at the limit that the port's unsharded
    Runner keeps to JAX's unsharded one here."""
    model = models[case]
    images = _images(BATCH, SIZE, 1 if case == "flagship" else 2)
    jr = jax_runner_mod.Runner(model["cfg"], model["weights"], dtype=jnp.float32, imgsz=SIZE, spatial_shards=2)
    assert jr.spatial_mesh is not None and dict(jr.spatial_mesh.shape) == {"data": 4, "model": 2}
    unsharded = jax_runner_mod.Runner(model["cfg"], model["weights"], dtype=jnp.float32, imgsz=SIZE)
    assert_same_kept_set(_unsharded(model, images)[1], unsharded(images, conf_thres=CONF))
    assert_same_kept_set(world2[0][1 if case == "flagship" else 2]["out"], jr(images, conf_thres=CONF))


def test_sharded_entry_points_equal_the_unsharded_ones(models, data, world2, tmp_path, monkeypatch):
    """val.run and detect.run with shard_spatial=2 give the unsharded
    results on every rank, rank 0 alone writes; attempt_load with two
    weights serves an unsharded ensemble. f32 throughout (detect builds a
    bf16 Runner unless its attempt_load is told otherwise)."""
    monkeypatch.setattr(detect, "attempt_load", functools.partial(attempt_load, dtype=torch.float32))
    flagship = models["flagship"]
    (res, maps, _) = val.run(data, weights=flagship["weights"], cfg=flagship["cfg"], batch_size=2, imgsz=SIZE,
                             half=False, device="cpu", project=str(tmp_path), name="val")
    run_dir = detect.run(weights=flagship["weights"], cfg=flagship["cfg"], source=data["val"], imgsz=SIZE,
                         conf_thres=CONF, save_txt=True, save_conf=True, project=str(tmp_path), name="detect",
                         device="cpu")
    assert res[2] > 0.5, res
    for r in (rank[3] for rank in world2):
        assert r["ensemble"]
        np.testing.assert_allclose(r["results"], res, rtol=0, atol=1e-6)
        np.testing.assert_allclose(r["maps"], maps, rtol=0, atol=1e-6)
    want = {p.name: p.read_text() for p in (run_dir / "labels").glob("*.txt")}
    # detect appends to a label file: rows written by both ranks would show twice
    got = {p.name: p.read_text() for p in (type(run_dir)(world2[0][3]["run_dir"]) / "labels").glob("*.txt")}
    assert sorted(got) == sorted(want) and len(want) > 0
    for name in want:  # `cls xc yc w h conf` rows, %g, normalized: ROW_BOX_TOL px of 256 is 4e-5
        g, w = ([[float(v) for v in line.split()] for line in text[name].splitlines()] for text in (got, want))
        ranks.match_rows(np.roll(g, -1, 1), np.roll(w, -1, 1), [1e-4] * 4 + [ROW_SCORE_TOL])


def test_val_int8_with_shard_spatial_serves_unsharded(models, data, tmp_path):
    """--int8 with --shard-spatial stays unsharded, as the JAX package's
    quantized_infer_fn never uses the spatial mesh: no process group is
    asked for, a log line says so, and the results are int8 val's own."""
    flagship = models["flagship"]
    kw = dict(weights=flagship["weights"], cfg=flagship["cfg"], batch_size=2, imgsz=64, half=False, device="cpu",
              project=str(tmp_path), int8=True)
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    val.LOGGER.addHandler(handler)
    try:
        sharded = val.run(data, name="sharded", shard_spatial=2, **kw)
    finally:
        val.LOGGER.removeHandler(handler)
    assert any("--int8 serves unsharded" in line for line in lines), lines
    np.testing.assert_array_equal(sharded[0], val.run(data, name="plain", **kw)[0])
