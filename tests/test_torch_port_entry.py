"""yolosomi_tpu_torch's serving entry points against the JAX package's, on
the CPU: LoadImages and LoadStreams, detect.run, AutoShape and Detections,
the REST server, attempt_load and the ensemble, soft-NMS, weighted boxes
fusion and its CLI, the second-stage classifier, the Runner's float input,
its head-type guard, and the hub loaders.

Both packages load one `.msgpack` that the JAX package wrote: the small
flagship (width 0.25, depth 0.33, 64 px) with the randomized variables and
BatchNorm scales spread as tests/test_torch_port_checkpoint.py explains,
and anchors 1.25 x the config's. JAX's entry points build bfloat16 Runners;
where the two packages are held to each other row by row, both run float32
(JAX's through a test-side monkeypatch of the Runner its module calls).
"""

import functools
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer

import cv2
import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

import detect as jax_detect
import serve as jax_serve
import wbf as jax_wbf_cli
from tests._torch_port_common import IMGSZ, NC, few_threads, jax_flagship, small_flagship_cfg  # noqa: F401
from tests.test_torch_port_checkpoint import ROWS_TOL, assert_rows_match, spread
from tests.test_torch_port_eval import _write_image
from yolosomi_tpu import api as jax_api
from yolosomi_tpu.data import datasets as jax_datasets
from yolosomi_tpu.engine import checkpoint as jax_ckpt
from yolosomi_tpu.engine import runner as jax_runner_mod
from yolosomi_tpu.ops import nms as jax_nms
from yolosomi_tpu.ops import wbf as jax_wbf
from yolosomi_tpu.utils import classifier as jax_classifier
from yolosomi_tpu_torch import api, detect, hubconf, serve
from yolosomi_tpu_torch import wbf as wbf_cli
from yolosomi_tpu_torch.data import datasets
from yolosomi_tpu_torch.engine import runner as runner_mod
from yolosomi_tpu_torch.engine.runner import EnsembleRunner, Runner, attempt_load
from yolosomi_tpu_torch.ops import nms, wbf
from yolosomi_tpu_torch.utils import classifier
from yolosomi_tpu_torch.utils.config import find_config, load_model_cfg

IMAGE_SIZES = [(64, 64), (48, 64), (80, 60), (33, 70), (120, 90), (64, 50)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The config, two weights files (seed-randomized variables, and the
    same with the head's class convs halved) written by the JAX package,
    and a directory of PNG and JPEG images of several sizes."""
    d = tmp_path_factory.mktemp("entry")
    cfg = small_flagship_cfg()
    _, jmeta, variables = jax_flagship(cfg)
    variables = spread(variables)
    cfg_path = d / "somi-small.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    anchors = (jmeta.anchors_px * 1.25).astype(np.float32)
    weights = [d / "a.msgpack", d / "b.msgpack"]
    jax_ckpt.save_variables(str(weights[0]), variables, anchors=anchors)
    head = max((k for k in variables["params"] if k.startswith("layers_")), key=lambda k: int(k.split("_")[1]))
    other = {"params": {**variables["params"], head: {
        lv: {**v, "c3": {"conv": {"kernel": v["c3"]["conv"]["kernel"] * np.float32(0.5),
                                  "bias": v["c3"]["conv"]["bias"]}}} for lv, v in variables["params"][head].items()}},
        "batch_stats": variables["batch_stats"]}
    jax_ckpt.save_variables(str(weights[1]), other, anchors=anchors)
    images = d / "images"
    images.mkdir()
    rng = np.random.default_rng(2)
    for i, (h, w) in enumerate(IMAGE_SIZES):
        _write_image(images / f"im{i}.{'png' if i % 2 else 'jpg'}", rng, h, w)
    return dict(dir=d, cfg=str(cfg_path), weights=[str(w) for w in weights], images=images, anchors=anchors)


def _jax_runner(files, i=0):
    return jax_runner_mod.Runner(files["cfg"], files["weights"][i], dtype=jnp.float32, imgsz=IMGSZ)


def _runner(files, i=0, dtype=torch.float32):
    return Runner(files["cfg"], files["weights"][i], dtype=dtype, device="cpu")


# ---------------------------------------------------------------------------
# 1. inference sources
# ---------------------------------------------------------------------------


def _write_video(path, n: int, shape=(48, 80)):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 10, shape[::-1])
    assert writer.isOpened()
    rng = np.random.default_rng(5)
    for _ in range(n):
        writer.write(rng.integers(0, 256, (*shape, 3), dtype=np.uint8))
    writer.release()


@pytest.mark.parametrize("auto", [False, True])
def test_load_images_bitwise_equal_jax(files, tmp_path, monkeypatch, auto):
    """The JAX LoadImages letterboxes with its C++ letterbox when that
    builds, which is close to cv2's but not equal (tests/test_native.py);
    the port keeps cv2. The C++ path is switched off here, on the JAX side
    only (`_NATIVE_OK`), so that the two are held to the same letterbox."""
    monkeypatch.setattr(jax_datasets, "_NATIVE_OK", False)
    src = tmp_path / "src"
    src.mkdir()
    for p in sorted(files["images"].iterdir()):
        (src / p.name).write_bytes(p.read_bytes())
    _write_video(src / "clip.avi", 3)
    ours = list(datasets.LoadImages(str(src), img_size=IMGSZ, stride=32, auto=auto))
    theirs = list(jax_datasets.LoadImages(str(src), img_size=IMGSZ, stride=32, auto=auto))
    assert len(ours) == len(theirs) == len(IMAGE_SIZES) + 3
    for (p, img, im0, cap), (jp, jimg, jim0, jcap) in zip(ours, theirs):
        assert p == jp and img.dtype == jimg.dtype == np.uint8
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(im0, jim0)
        assert (cap is None) == (jcap is None)
    single = datasets.LoadImages(str(src / "im0.jpg"), img_size=IMGSZ)
    assert len(single) == 1 and next(iter(single))[1].shape == (IMGSZ, IMGSZ, 3)
    with pytest.raises(FileNotFoundError):
        datasets.LoadImages(str(tmp_path / "nothing"))


def test_load_streams_letterboxes_each_source_and_stops(tmp_path):
    path = tmp_path / "stream.avi"
    _write_video(path, 40)
    streams = datasets.LoadStreams([str(path), str(path)], img_size=IMGSZ, stride=32)
    try:
        sources, batch, frames, cap = next(iter(streams))
        assert sources == [str(path), str(path)] and cap is None
        assert batch.shape == (2, IMGSZ, IMGSZ, 3) and batch.dtype == np.uint8
        assert frames[0].shape == (48, 80, 3)
    finally:
        streams.close()
    assert not any(t.is_alive() for t in streams.threads)
    with pytest.raises(OSError, match="failed to read"):
        datasets.LoadStreams(str(tmp_path / "missing.avi"))


# ---------------------------------------------------------------------------
# 2. the Runner: float input, head-type guard, ensembles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_uint8_and_float_input_give_the_same_bits(files, dtype):
    """A uint8 batch is divided by 255 on the device in the compute dtype;
    the same batch as float32 / 255 (the JAX AutoShape's input) is cast to
    it. Both round the float32 quotient once, so they agree bit for bit."""
    runner = _runner(files, dtype=dtype)
    x = np.random.default_rng(7).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    xf = x.astype(np.float32) / 255.0
    assert torch.equal(runner.upload(x), runner.upload(xf))
    for a, b in zip(runner.forward(x), runner.forward(xf)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(runner(x, conf_thres=0.25), runner(xf, conf_thres=0.25))
    for bad in (x.astype(np.int32), x[0]):
        with pytest.raises(TypeError):
            runner(bad)


def test_head_type_guard_raises_for_heads_that_decode_otherwise(files):
    """Every head of the registry has a postprocess since the heads were
    ported; a head type the Runner does not know raises, naming it, in the
    serving and the val protocol and for an ensemble member."""
    runner = _runner(files)
    x = np.zeros((1, IMGSZ, IMGSZ, 3), np.uint8)
    assert runner.meta.head_type in runner_mod.ANCHOR_HEADS
    runner.meta.head_type = "DetectV99"
    for kw in (dict(), dict(multi_label=True, exact=True)):
        with pytest.raises(ValueError, match="unknown head type 'DetectV99'"):
            runner(x, **kw)
    ens = EnsembleRunner(files["cfg"], files["weights"], dtype=torch.float32, device="cpu")
    ens.members[1].meta.head_type = "SegmentV99"
    with pytest.raises(ValueError, match="unknown head type 'SegmentV99'"):
        ens(x)


def test_attempt_load_dispatch(files):
    one = attempt_load(files["weights"][0], files["cfg"], dtype=torch.float32, device="cpu")
    also_one = attempt_load(files["weights"][:1], files["cfg"], dtype=torch.float32, device="cpu")
    ens = attempt_load(files["weights"], files["cfg"], dtype=torch.float32, device="cpu")
    assert type(one) is Runner and type(also_one) is Runner and isinstance(ens, EnsembleRunner)
    assert len(ens.members) == 2 and ens.stride == 32 and ens.names == one.names
    # several weights serve unsharded whatever spatial_shards says, as the JAX package's attempt_load does
    assert type(attempt_load(files["weights"], files["cfg"], device="cpu", spatial_shards=2)) is EnsembleRunner
    # TTA: each member's three passes, one NMS (held to JAX in tests/test_torch_port_tta.py)
    rows = ens(np.random.default_rng(7).integers(0, 256, (1, IMGSZ, IMGSZ, 3), dtype=np.uint8), conf_thres=0.25,
               augment=True)
    assert rows.shape == (1, 300, 6) and (rows[..., 4] > 0).any() and np.isfinite(rows).all()


def test_ensemble_of_identical_models_equals_the_single_model(files):
    """Each row appears twice in the pooled candidates; the twin with the
    higher index is suppressed by the other (IoU 1), so the keep-set is the
    single model's while the pool stays under max_nms."""
    single = _runner(files)
    ens = EnsembleRunner(files["cfg"], [files["weights"][0]] * 2, dtype=torch.float32, device="cpu")
    x = np.random.default_rng(8).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    for kw in (dict(conf_thres=0.27, max_det=50), dict(conf_thres=0.27, multi_label=True)):
        np.testing.assert_array_equal(ens(x, **kw), single(x, exact=True, **kw))


def test_ensemble_matches_jax(files):
    x = np.random.default_rng(9).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    ens = attempt_load(files["weights"], files["cfg"], dtype=torch.float32, device="cpu")
    jens = jax_runner_mod.EnsembleRunner(files["cfg"], files["weights"], dtype=jnp.float32, imgsz=IMGSZ)
    assert_rows_match(ens(x, conf_thres=0.25), jens(x, conf_thres=0.25))


# ---------------------------------------------------------------------------
# 3. detect
# ---------------------------------------------------------------------------


def _labels(run_dir) -> dict:
    return {p.name: [[float(v) for v in line.split()] for line in p.read_text().splitlines()]
            for p in sorted((run_dir / "labels").glob("*.txt"))}


@pytest.fixture
def f32_jax_detect(monkeypatch):
    """JAX's detect builds a bfloat16 Runner and, where it builds, letterboxes
    with its C++ code; both are set to the port's float32 and cv2 here."""
    monkeypatch.setattr(jax_runner_mod, "attempt_load",
                        functools.partial(jax_runner_mod.attempt_load, dtype=jnp.float32))
    monkeypatch.setattr(jax_datasets, "_NATIVE_OK", False)
    monkeypatch.setattr(detect, "attempt_load", functools.partial(attempt_load, dtype=torch.float32))


@pytest.mark.parametrize("ensemble", [False, True], ids=["single", "ensemble"])
def test_detect_writes_the_labels_jax_writes(files, tmp_path, f32_jax_detect, ensemble):
    weights = files["weights"] if ensemble else files["weights"][0]
    kw = dict(weights=weights, cfg=files["cfg"], source=str(files["images"]), imgsz=IMGSZ, conf_thres=0.25,
              save_txt=True, save_conf=True, project=str(tmp_path), exist_ok=True)
    ours = detect.run(name="port", device="cpu", **kw)
    theirs = jax_detect.run(name="jax", **kw)
    got, ref = _labels(ours), _labels(theirs)
    assert sorted(got) == sorted(ref) and len(got) == len(IMAGE_SIZES)
    for name in ref:
        g, r = np.array(got[name]), np.array(ref[name])
        assert g.shape == r.shape and g.shape[1] == 6, name
        np.testing.assert_array_equal(g[:, 0], r[:, 0])
        np.testing.assert_allclose(g[:, 1:], r[:, 1:], rtol=0, atol=1e-5, err_msg=name)
    annotated = sorted(p.name for p in ours.iterdir() if p.suffix in (".png", ".jpg"))
    assert annotated == sorted(p.name for p in files["images"].iterdir())


def test_detect_txt_rows_are_the_runners_rows(files, tmp_path):
    """The label file of an image holds the Runner's rows on the
    letterboxed image, mapped back and normalized, to the printed digits."""
    run_dir = detect.run(weights=files["weights"][0], cfg=files["cfg"], source=str(files["images"] / "im4.jpg"),
                         imgsz=IMGSZ, conf_thres=0.25, save_txt=True, save_conf=True, save_crop=True, nosave=True,
                         device="cpu", project=str(tmp_path), name="one")
    im0 = cv2.imread(str(files["images"] / "im4.jpg"))
    img = datasets.LoadImages(str(files["images"] / "im4.jpg"), img_size=IMGSZ)
    img = next(iter(img))[1]
    det = Runner(files["cfg"], files["weights"][0], device="cpu")(img[None], conf_thres=0.25, iou_thres=0.2)[0]
    det = det[det[:, 4] > 0]
    from yolosomi_tpu_torch.utils.boxes import scale_coords

    det[:, :4] = scale_coords(img.shape[:2], det[:, :4], im0.shape[:2])
    want = [detect.label_line(int(c), xyxy, im0.shape, conf) for *xyxy, conf, c in det]
    assert (run_dir / "labels" / "im4.txt").read_text().splitlines() == want and len(want) > 0
    assert list((run_dir / "crops").rglob("im4.jpg"))


def test_detect_video_and_a_callable_classifier(files, tmp_path):
    src = tmp_path / "video"
    src.mkdir()
    _write_video(src / "clip.avi", 4, (64, 64))
    calls = []

    def classify(batch):  # keeps every detection of class 0
        calls.append(batch.shape)
        out = np.zeros((len(batch), NC), np.float32)
        out[:, 0] = 1.0
        return out

    run_dir = detect.run(weights=files["weights"][0], cfg=files["cfg"], source=str(src), imgsz=IMGSZ,
                         conf_thres=0.25, save_txt=True, classify=classify, device="cpu", project=str(tmp_path))
    assert (run_dir / "clip.mp4").exists() and calls and all(s[1:] == (224, 224, 3) for s in calls)
    rows = [line.split() for p in (run_dir / "labels").glob("*.txt") for line in p.read_text().splitlines()]
    assert rows and all(r[0] == "0" for r in rows)


@pytest.mark.parametrize("kw, error, match", [
    (dict(visualize=True), NotImplementedError, "item 9"), (dict(shard_spatial=2), RuntimeError, "torchrun")],
    ids=["visualize", "shard"])
def test_detect_refuses_what_is_not_ported(kw, error, match, tmp_path):
    """What is not ported raises, naming its ROADMAP item; spatial sharding
    without a process group raises, naming torchrun."""
    with pytest.raises(error, match=match):
        detect.run(source=str(tmp_path), project=str(tmp_path), **kw)


def test_detect_cli_and_its_cuda_default(files, tmp_path):
    opt = detect.parse_opt(["--weights", *files["weights"], "--cfg", files["cfg"], "--source", str(files["images"]),
                            "--imgsz", str(IMGSZ), "--device", "cpu", "--project", str(tmp_path), "--nosave"])
    assert opt.weights == files["weights"] and opt.device == "cpu" and opt.conf_thres == 0.4
    assert detect.main(opt).is_dir()
    assert detect.parse_opt([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            detect.run(weights=files["weights"][0], cfg=files["cfg"], source=str(files["images"]),
                       project=str(tmp_path))


# ---------------------------------------------------------------------------
# 4. AutoShape, Detections, the server, hubconf
# ---------------------------------------------------------------------------


def _both_autoshapes(files):
    ours = api.AutoShape(_runner(files), imgsz=IMGSZ, conf=0.25)
    theirs = jax_api.AutoShape(_jax_runner(files), imgsz=IMGSZ, conf=0.25)
    return ours, theirs


def _assert_records_match(got, ref):
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert list(g) == list(r) == list(api.RECORD_KEYS)
        assert [type(v) for v in g.values()] == [type(v) for v in r.values()]
        assert (g["class"], g["name"]) == (r["class"], r["name"])
        np.testing.assert_allclose([g[k] for k in api.RECORD_KEYS[:5]], [r[k] for k in api.RECORD_KEYS[:5]],
                                   rtol=0, atol=1e-4)


def test_autoshape_and_detections_equal_jax(files, tmp_path):
    ours, theirs = _both_autoshapes(files)
    rng = np.random.default_rng(10)
    ims = [rng.integers(0, 256, (90, 120, 3), dtype=np.uint8), rng.integers(0, 256, (50, 40), dtype=np.uint8),
           str(files["images"] / "im1.png")]
    got, ref = ours(ims), theirs(ims)
    assert repr(got) == repr(ref) and "image 3/3" in repr(got) and len(got) == 3
    for g, r in zip(got.pred, ref.pred):
        assert g.shape == r.shape
        np.testing.assert_array_equal(g[:, 5], r[:, 5])
        np.testing.assert_allclose(g[:, :5], r[:, :5], rtol=0, atol=1e-4)
    for g, r in zip(got.records(), [df.to_dict(orient="records") for df in ref.pandas()]):
        _assert_records_match(g, r)
    assert [list(df.columns) for df in got.pandas()] == [list(api.RECORD_KEYS)] * 3
    assert got.xyxy is got.pred
    saved = got.save(str(tmp_path / "saved"))
    assert sorted(p.name for p in saved.iterdir()) == ["im1.png", "image0.jpg", "image1.jpg"]
    crops = got.crop(str(tmp_path / "crops"))
    nonempty = sum(int(x2) > max(int(x1), 0) and int(y2) > max(int(y1), 0)
                   for det in got.pred for x1, y1, x2, y2 in det[:, :4])
    assert len(crops) == nonempty > 0 and len(list((tmp_path / "crops").rglob("*.jpg"))) == nonempty


def test_apply_classifier_equals_jax(files):
    ours, theirs = _both_autoshapes(files)
    ims = [cv2.imread(str(p)) for p in sorted(files["images"].iterdir())[:3]]

    def classify(batch):  # class = 1 where the crop is brighter than mid-grey
        out = np.zeros((len(batch), NC), np.float32)
        out[np.arange(len(batch)), 1 + (np.asarray(batch).mean((1, 2, 3)) > 0.5)] = 1.0
        return out

    got = api.apply_classifier(ours(ims), classify)
    ref = jax_api.apply_classifier(theirs(ims), classify)
    assert [len(p) for p in got.pred] == [len(p) for p in ref.pred]
    dets = np.array([[10, 10, 40, 40, 0.9, 0], [50, 50, 90, 90, 0.8, 1], [20, 60, 60, 95, 0.7, 2],
                     [0, 0, 1, 1, 0.6, 1]], np.float32)
    im0 = np.random.default_rng(11).integers(0, 255, (100, 120, 3), np.uint8)
    np.testing.assert_array_equal(classifier.apply_classifier(dets, classify, im0),
                                  jax_classifier.apply_classifier(dets, classify, im0))
    torch_classify = lambda b: torch.from_numpy(classify(b))  # noqa: E731  a torch model's logits
    np.testing.assert_array_equal(classifier.apply_classifier(dets, torch_classify, im0),
                                  jax_classifier.apply_classifier(dets, classify, im0))


def _multipart(payload: bytes, boundary=b"BoUnDaRy123"):
    body = (b"--" + boundary + b"\r\nContent-Disposition: form-data; name=\"comment\"\r\n\r\n"
            + b"x" * (len(payload) + 500) + b"\r\n--" + boundary
            + b"\r\nContent-Disposition: form-data; name=\"image\"; filename=\"f.jpg\"\r\n"
            + b"Content-Type: image/jpeg\r\n\r\n" + payload + b"\r\n--" + boundary + b"--\r\n")
    return body, "multipart/form-data; boundary=" + boundary.decode()


def _post(url, body, ctype=None):
    headers = {"Content-Type": ctype} if ctype else {}
    req = urllib.request.Request(url, data=body, headers=headers, method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.fixture
def servers(files):
    """The port's DetectionServer and the JAX server (its module-level model
    set as tests/test_serve.py sets it), each on an ephemeral port."""
    ours_model, theirs_model = _both_autoshapes(files)
    ours = serve.DetectionServer(("127.0.0.1", 0), ours_model)
    jax_serve._MODEL = theirs_model
    theirs = ThreadingHTTPServer(("127.0.0.1", 0), jax_serve.Handler)
    threads = [threading.Thread(target=s.serve_forever, daemon=True) for s in (ours, theirs)]
    for t in threads:
        t.start()
    yield [f"http://127.0.0.1:{s.server_address[1]}" for s in (ours, theirs)], ours_model
    for s in (ours, theirs):
        s.shutdown()
    ours.close()
    theirs.server_close()
    for t in threads:
        t.join(timeout=10)
    jax_serve._MODEL = None


def test_servers_answer_the_same_records(servers, files):
    (ours, theirs), model = servers
    enc = (files["images"] / "im4.jpg").read_bytes()
    route = "/v1/object-detection/somi"
    got = _post(ours + route, enc)
    _assert_records_match(got, _post(theirs + route, enc))
    body, ctype = _multipart(enc)
    assert _post(ours + route, body, ctype) == got
    direct = model(cv2.imdecode(np.frombuffer(enc, np.uint8), cv2.IMREAD_COLOR)).records()[0]
    assert json.loads(json.dumps(direct)) == got
    with urllib.request.urlopen(ours + "/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok"}


@pytest.mark.parametrize("body, ctype, code", [(b"not an image", None, 400), (b"", None, 400),
                                               (b"--nope\r\ntotal garbage", "multipart/form-data; boundary=other",
                                                400)], ids=["garbage", "empty", "multipart-garbage"])
def test_server_refuses_bad_requests(servers, body, ctype, code):
    (ours, _), _ = servers
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(ours + "/v1/object-detection/somi", body, ctype)
    assert err.value.code == code
    with pytest.raises(urllib.error.HTTPError) as err:
        _post(ours + "/elsewhere", b"x")
    assert err.value.code == 404


def test_multipart_parser_equals_jax():
    body, ctype = _multipart(b"\xff\xd8JPEGDATA")
    assert serve.parse_multipart_image(body, ctype) == jax_serve.parse_multipart_image(body, ctype) == b"\xff\xd8JPEGDATA"
    bare = (b"--x\r\nContent-Disposition: form-data; name=\"meta\"\r\n\r\nblob\r\n--x\r\n"
            b"Content-Disposition: form-data; name=\"file\"\r\nContent-Type: image/png\r\n\r\nPNGDATA\r\n--x--\r\n")
    assert serve.parse_multipart_image(bare, "multipart/form-data; boundary=x") == b"PNGDATA"
    assert serve.parse_multipart_image(b"junk", "text/plain") is None


def test_hub_loaders(files, monkeypatch):
    model = hubconf.custom(files["cfg"], files["weights"][0], imgsz=IMGSZ, conf=0.25, device="cpu")
    assert isinstance(model, api.AutoShape) and model.runner.meta.nc == NC
    np.testing.assert_array_equal(model.runner.meta.anchors_px, files["anchors"])
    assert isinstance(hubconf.custom(files["cfg"], files["weights"][0], autoshape=False, device="cpu"), Runner)
    seen = []
    monkeypatch.setattr(hubconf, "load", lambda cfg, weights=None, **kw: seen.append((cfg, weights, kw)))
    for fn, cfg in ((hubconf.yolo_somi, "yolo-somi"), (hubconf.yolo_somi_dcn, "yolo-somi-dcn"),
                    (hubconf.yolov5s, "yolov5s"), (hubconf.yolov5l, "yolov5l")):
        fn(weights="w.msgpack", device="cpu")
        assert seen[-1] == (cfg, "w.msgpack", {"device": "cpu"})


@pytest.mark.parametrize("fn", ["yolov5s", "yolov5l", "yolov3-tiny"])
def test_yolov5_hub_loaders_name_the_queue_item(fn):
    """The yolov5 loaders, and hubconf.custom on yolov3-tiny (its
    nn.MaxPool2d and nn.ZeroPad2d rows ported since; a row outside the
    registry raises KeyError naming it and its row, as the JAX parser
    does, tests/test_torch_port_zoo.py), build their YAML's model (nc 80, its
    anchors, the coupled Detect head) and answer an AutoShape call on the
    CPU."""
    model = hubconf.custom(fn, device="cpu", imgsz=64) if fn == "yolov3-tiny" else getattr(hubconf, fn)(device="cpu",
                                                                                                       imgsz=64)
    yaml_cfg = load_model_cfg(find_config(fn))
    assert model.runner.meta.nc == yaml_cfg["nc"] == 80 and model.runner.meta.head_type == "Detect"
    levels = len(yaml_cfg["anchors"])
    np.testing.assert_array_equal(model.runner.meta.anchors_px.reshape(levels, -1), yaml_cfg["anchors"])
    image = np.random.default_rng(0).integers(0, 256, (48, 64, 3), dtype=np.uint8)
    assert len(model([image]).pred) == 1


def test_entry_points_default_to_cuda(files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.load(files["cfg"], files["weights"][0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        attempt_load(files["weights"], files["cfg"])


# ---------------------------------------------------------------------------
# 5. soft-NMS and weighted boxes fusion
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ciou", [True, False], ids=["ciou", "iou"])
def test_soft_nms_scores_equal_jax(ciou):
    rng = np.random.default_rng(12)
    xy = rng.random((80, 2)).astype(np.float32) * 100
    boxes = np.concatenate([xy, xy + rng.random((80, 2)).astype(np.float32) * 40 + 1], 1)
    scores = rng.random(80).astype(np.float32)
    got = nms.soft_nms_scores(torch.from_numpy(boxes), torch.from_numpy(scores), max_det=50, ciou=ciou).numpy()
    ref = np.asarray(jax_nms.soft_nms_scores(jnp.asarray(boxes), jnp.asarray(scores), max_det=50, ciou=ciou))
    assert (got > 0).sum() == 50
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def _wbf_inputs(seed: int, n_models: int):
    rng = np.random.default_rng(seed)
    base = rng.random((12, 2)) * 0.7
    out = []
    for _ in range(n_models):
        xy = base + rng.normal(0, 0.01, base.shape)
        boxes = np.concatenate([xy, xy + 0.1 + rng.random((12, 2)) * 0.1], 1).clip(0, 1)
        out.append((boxes, rng.random(12), rng.integers(0, 3, 12).astype(float)))
    return [b for b, _, _ in out], [s for _, s, _ in out], [c for _, _, c in out]


@pytest.mark.parametrize("kw", [dict(), dict(weights=[2, 1, 1]), dict(conf_type="max", iou_thr=0.4),
                                dict(skip_box_thr=0.5)], ids=["default", "weights", "max", "skip"])
def test_weighted_boxes_fusion_equals_jax_exactly(kw):
    args = _wbf_inputs(13, 3)
    got, ref = wbf.weighted_boxes_fusion(*args, **kw), jax_wbf.weighted_boxes_fusion(*args, **kw)
    assert len(got[0]) > 0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    empty = wbf.weighted_boxes_fusion([np.zeros((0, 4))], [np.zeros(0)], [np.zeros(0)])
    assert [a.shape for a in empty] == [(0, 4), (0,), (0,)]


def test_wbf_cli_writes_the_files_jax_writes(tmp_path):
    boxes, scores, labels = _wbf_inputs(14, 2)
    dirs = []
    for m, (b, s, c) in enumerate(zip(boxes, scores, labels)):
        d = tmp_path / f"m{m}"
        d.mkdir()
        for img in range(3):
            sel = slice(img * 4, img * 4 + 4 - m)  # model 1 misses a box per image
            rows = [f"{int(ci)} {(x1 + x2) / 2:g} {(y1 + y2) / 2:g} {x2 - x1:g} {y2 - y1:g} {si:g}"
                    for (x1, y1, x2, y2), si, ci in zip(b[sel], s[sel], c[sel])]
            (d / f"img{img}.txt").write_text("\n".join(rows) + "\n")
        dirs.append(str(d))
    (tmp_path / "m0" / "only0.txt").write_text("1 0.5 0.5 0.2 0.2\n")  # no conf column, one model only
    wbf_cli.main(["--dirs", *dirs, "--out", str(tmp_path / "port"), "--weights", "2", "1"])
    jax_wbf_cli.main(["--dirs", *dirs, "--out", str(tmp_path / "jax"), "--weights", "2", "1"])
    ours = sorted((tmp_path / "port").iterdir())
    assert [p.name for p in ours] == ["img0.txt", "img1.txt", "img2.txt", "only0.txt"]
    for p in ours:
        assert p.read_text() == (tmp_path / "jax" / p.name).read_text() != ""
