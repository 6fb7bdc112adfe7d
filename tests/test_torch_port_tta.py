"""Test-time augmentation in yolosomi_tpu_torch (ops/tta.py, the Runner's
and the EnsembleRunner's `augment=True`, detect.run and val.run
`augment`) against the JAX package, on the CPU.

The small flagship (width 0.25, depth 0.33) serves at 256 px, where the
three canvases are 256, 224 and 192 px, so the passes' rows differ in
number and clip_augmented drops rows of two sizes (at 64 px all three
canvases are 64). Its variables are the randomized ones of
tests/_torch_port_common.py with BatchNorm scales x10, as
tests/test_torch_port_spatial.py spreads them at 256 px: the scores above
CONF then spread over 0.5-0.9. Rows are held at that file's limits: at
256 px a box decodes a head output's rounding times up to 8 x its anchor,
so the two packages' f32 boxes lie a few 1e-3 px apart.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from tests._torch_port_common import few_threads, jax_flagship, small_flagship_cfg  # noqa: F401
from tests.test_torch_port_checkpoint import assert_rows_match, spread
from tests.test_torch_port_eval import _write_image
from yolosomi_tpu.engine import checkpoint as jax_ckpt
from yolosomi_tpu.engine import runner as jax_runner_mod
from yolosomi_tpu.ops import tta as jax_tta
from yolosomi_tpu_torch import detect, val
from yolosomi_tpu_torch.data import datasets
from yolosomi_tpu_torch.engine.runner import EnsembleRunner, Runner
from yolosomi_tpu_torch.ops import tta
from yolosomi_tpu_torch.utils.boxes import scale_coords

SIZE, GAIN, CONF = 256, 10.0, 0.5
ROW_BOX_TOL, ROW_SCORE_TOL = 1e-2, 2e-5  # tests/test_torch_port_spatial.py's limits at 256 px
SCALE_TOL = 2e-5  # scale_img in f32: antialiased bilinear, as jax.image.resize shrinks


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The small flagship's config and two weights files written by the JAX
    package (the randomized variables spread x10, and the same with the
    head's class convs halved)."""
    d = tmp_path_factory.mktemp("tta")
    cfg = small_flagship_cfg()
    _, jmeta, variables = jax_flagship(cfg)
    variables = spread(variables, GAIN)
    cfg_path = d / "somi-small.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    anchors = jmeta.anchors_px.astype(np.float32)
    weights = [d / "a.msgpack", d / "b.msgpack"]
    jax_ckpt.save_variables(str(weights[0]), variables, anchors=anchors)
    head = max((k for k in variables["params"] if k.startswith("layers_")), key=lambda k: int(k.split("_")[1]))
    other = {"params": {**variables["params"], head: {
        lv: {**v, "c3": {"conv": {"kernel": v["c3"]["conv"]["kernel"] * np.float32(0.5),
                                  "bias": v["c3"]["conv"]["bias"]}}} for lv, v in variables["params"][head].items()}},
        "batch_stats": variables["batch_stats"]}
    jax_ckpt.save_variables(str(weights[1]), other, anchors=anchors)
    return dict(dir=d, cfg=str(cfg_path), weights=[str(w) for w in weights])


def _images(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, SIZE, SIZE, 3), dtype=np.uint8)


def _rows_match(got: np.ndarray, ref: np.ndarray) -> None:
    """assert_rows_match at the 256-px box limit, and the scores at theirs."""
    assert_rows_match(got, ref, ROW_BOX_TOL)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g[g[:, 4] > 0][:, 4], r[r[:, 4] > 0][:, 4], rtol=0, atol=ROW_SCORE_TOL)


# ---------------------------------------------------------------------------
# ops/tta.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ratio", [0.83, 0.67])
@pytest.mark.parametrize("hw", [(64, 64), (480, 640)], ids=["64", "480x640"])
def test_scale_img_matches_jax(hw, ratio):
    """The resized, gs-padded canvas of an NCHW f32 batch against JAX's on
    NHWC: the same truncated size and padded canvas, within SCALE_TOL."""
    x = np.random.default_rng(0).random((2, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax_tta.scale_img(jnp.asarray(x), ratio))
    got = tta.scale_img(torch.from_numpy(x).permute(0, 3, 1, 2), ratio).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=SCALE_TOL)
    pad = int(hw[0] * ratio)
    assert (got[:, pad:] == np.float32(0.447)).all()


def test_scale_img_at_ratio_1_is_the_image():
    x = torch.rand(1, 3, 32, 32)
    assert tta.scale_img(x, 1.0) is x


@pytest.mark.parametrize("flip", [None, "lr"])
def test_descale_pred_bit_equal_to_jax(flip):
    rows = (np.random.default_rng(1).random((2, 50, 8)) * 300).astype(np.float32)
    ref = np.asarray(jax_tta.descale_pred(jnp.asarray(rows), flip, 0.83, 256))
    np.testing.assert_array_equal(tta.descale_pred(torch.from_numpy(rows), flip, 0.83, 256).numpy(), ref)


@pytest.mark.parametrize("nl", [3, 4])
def test_clip_augmented_bit_equal_to_jax(nl):
    """Rows of three passes at 256 / 224 / 192 px, stride 32 at the
    coarsest level: the first pass loses its coarsest level, the last its
    finest, as JAX clips them."""
    rng = np.random.default_rng(nl)
    g = sum(4 ** i for i in range(nl))
    rows = [rng.random((2, 3 * g * (side // 32 // 2 ** (4 - nl)) ** 2, 8)).astype(np.float32)
            for side in (256, 224, 192)]
    ref = jax_tta.clip_augmented([jnp.asarray(r) for r in rows], nl)
    got = tta.clip_augmented([torch.from_numpy(r) for r in rows], nl)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[0].shape[1] == rows[0].shape[1] * (g - 1) // g
    assert got[2].shape[1] == rows[2].shape[1] * (g - 4 ** (nl - 1)) // g


# ---------------------------------------------------------------------------
# the Runner, the ensemble, detect and val
# ---------------------------------------------------------------------------


def test_runner_tta_goes_through_three_canvases(files, monkeypatch):
    """The canvases 256, 224 and 192, the middle one flipped; the rows that
    reach the NMS are the three passes' less the clipped levels; and
    augment=True gives other rows than the plain forward."""
    runner = Runner(files["cfg"], files["weights"][0], dtype=torch.float32, device="cpu")
    seen, forward = [], runner.forward_tensor
    monkeypatch.setattr(runner, "forward_tensor", lambda x: seen.append(tuple(x.shape)) or forward(x))
    x = _images(2, 4)
    rows = runner.augment_rows(runner.upload(x))
    assert seen == [(2, 3, 256, 256), (2, 3, 224, 224), (2, 3, 192, 192)]
    per_pixel = 4 * (1 / 16 + 1 / 64 + 1 / 256 + 1 / 1024)  # na x levels at strides 4-32
    n = [int(s * s * per_pixel) for s in (256, 224, 192)]
    assert rows.shape == (2, n[0] * 84 // 85 + n[1] + n[2] * 21 // 85, 8)
    assert not np.array_equal(runner(x, conf_thres=CONF, augment=True), runner(x, conf_thres=CONF))


def test_runner_tta_rows_match_jax(files):
    """Single-label serving with augment=True against JAX's
    Runner.infer_fn(augment=True), f32."""
    x = _images(2, 1)
    jrunner = jax_runner_mod.Runner(files["cfg"], files["weights"][0], dtype=jnp.float32, imgsz=SIZE)
    ref = np.asarray(jrunner.infer_fn(conf_thres=CONF, augment=True)(jrunner.variables, jnp.asarray(x)))
    got = Runner(files["cfg"], files["weights"][0], dtype=torch.float32, device="cpu")(x, conf_thres=CONF,
                                                                                     augment=True)
    _rows_match(got, ref)


def test_ensemble_tta_rows_match_jax(files):
    """Each member's TTA rows, one multi-label exact NMS (val's protocol)
    over both, against JAX's EnsembleRunner.infer_fn(augment=True)."""
    x = _images(2, 2)
    kw = dict(conf_thres=CONF, iou_thres=0.6, multi_label=True, exact=True, max_nms=30000)
    jens = jax_runner_mod.EnsembleRunner(files["cfg"], files["weights"], dtype=jnp.float32, imgsz=SIZE)
    ref = np.asarray(jens.infer_fn(augment=True, **kw)(jens.variables, jnp.asarray(x)))
    ens = EnsembleRunner(files["cfg"], files["weights"], dtype=torch.float32, device="cpu")
    _rows_match(ens(x, augment=True, **kw), ref)


def test_detect_augment_writes_the_runners_tta_rows(files, tmp_path):
    """detect.run(augment=True) writes the rows of the Runner's TTA on the
    letterboxed images, mapped back, to the printed digits (both bf16, as
    detect builds its Runner)."""
    src = tmp_path / "images"
    src.mkdir()
    rng = np.random.default_rng(5)
    for i, (h, w) in enumerate([(256, 256), (200, 256)]):
        _write_image(src / f"im{i}.jpg", rng, h, w)
    run_dir = detect.run(weights=files["weights"][0], cfg=files["cfg"], source=str(src), imgsz=SIZE, conf_thres=CONF,
                         save_txt=True, save_conf=True, nosave=True, augment=True, device="cpu",
                         project=str(tmp_path), name="tta")
    runner = Runner(files["cfg"], files["weights"][0], device="cpu")
    n = 0
    for path, img, im0, _ in datasets.LoadImages(str(src), img_size=SIZE, stride=runner.stride, auto=False):
        det = runner(img[None], conf_thres=CONF, iou_thres=0.2, augment=True)[0]
        det = det[det[:, 4] > 0]
        det[:, :4] = scale_coords(img.shape[:2], det[:, :4], im0.shape[:2])
        want = [detect.label_line(int(c), xyxy, im0.shape, conf) for *xyxy, conf, c in det]
        label = run_dir / "labels" / f"{Path(path).stem}.txt"
        assert label.read_text().splitlines() == want
        n += len(want)
    assert n > 0


def test_val_augment_evaluates_the_runners_tta_rows(files, tmp_path, monkeypatch):
    """val.run(augment=True) asks the Runner for TTA under the eval
    protocol on every batch, and its mAP is the one of the same run on
    those rows (augment=False through a Runner whose plain call is TTA)."""
    root = tmp_path / "set"
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(6)
    for i in range(4):
        _write_image(root / "images" / f"im{i}.png", rng, 256, 256)
        (root / "labels" / f"im{i}.txt").write_text("0 0.5 0.5 0.3 0.3\n1 0.25 0.3 0.2 0.1\n")
    data = {"path": str(root), "val": str(root / "images"), "nc": 3, "names": ["a", "b", "c"]}
    runner = Runner(files["cfg"], files["weights"][0], dtype=torch.float32, device="cpu")
    calls = []
    call = Runner.__call__

    def spy(self, images, **kw):
        calls.append(kw.get("augment"))
        return call(self, images, **kw)

    monkeypatch.setattr(Runner, "__call__", spy)
    kw = dict(data=data, batch_size=2, imgsz=SIZE, runner=runner, project=str(tmp_path), exist_ok=True)
    tta_res = val.run(augment=True, name="tta", **kw)[0]
    assert calls == [True, True]
    monkeypatch.setattr(Runner, "__call__", lambda self, images, **kw: call(self, images, **{**kw, "augment": True}))
    np.testing.assert_array_equal(tta_res, val.run(name="forced", **kw)[0])
