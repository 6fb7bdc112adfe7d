"""yolosomi_tpu_torch's checkpoint files against the JAX package's, on the
CPU: the port's msgpack codec against flax.serialization, weights files and
full checkpoints written by the JAX package loaded by the port's Runner
(anchors, nc, EMA), the inverse weight bridge, strip_checkpoint's bfloat16
files, val.run from a weights file, and bfloat16 BatchNorm.

Weights: the randomized flax variables of tests/_torch_port_common.py
draw every BatchNorm scale as randn * 0.1, which shrinks the signal about
tenfold a layer, so the small flagship's scores hardly depend on the image
(421 distinct scores among 1360 boxes of a 64 px image). XLA's and torch's
float32 sigmoids differ in the last bit of about 2% of values, and such
near-ties then order differently in the two packages' NMS. Tests that hold
detections of the two packages row by row therefore multiply the BN scales
by BN_GAIN (`spread`), after which every box has a score of its own. The
bfloat16 BatchNorm test keeps the fixture as it is.
"""

import copy
import math
import threading

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
from flax import serialization

import val as jax_val
from tests._torch_port_common import (IMGSZ, NC, _to_dict, few_threads, jax_flagship,  # noqa: F401
                                      random_variables, small_flagship_cfg)
from tests.test_torch_port_dcn import small_dcn_cfg
from tests.test_torch_port_eval import _run_logged, _table, _write_image
from yolosomi_tpu.data import datasets as jax_datasets
from yolosomi_tpu.engine import checkpoint as jax_ckpt
from yolosomi_tpu.engine import runner as jax_runner_mod
from yolosomi_tpu.models.yolo import build_model as jax_build_model
from yolosomi_tpu.utils import boxes as jax_boxes
from yolosomi_tpu_torch import val
from yolosomi_tpu_torch.engine import checkpoint
from yolosomi_tpu_torch.engine.optim import make_optimizer
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.engine.trainer import create_train_state
from yolosomi_tpu_torch.models.yolo import build_model
from yolosomi_tpu_torch.utils import msgpack
from yolosomi_tpu_torch.utils.config import find_config, load_hyp
from yolosomi_tpu_torch.utils.general import LOGGER
from yolosomi_tpu_torch.utils.weights import _leaves, export_jax_variables, export_param_tree, load_jax_variables

BN_GAIN = 5.0
ROWS_TOL = 1e-5  # (B, 300, 6) rows of the two packages in f32: absolute, plus 1e-6 relative (2 ulp at 128 px)


def spread(variables: dict, gain: float = BN_GAIN) -> dict:
    """The variables with every norm scale multiplied by `gain`."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else (v * np.float32(gain) if k == "scale" else v)
                for k, v in tree.items()}

    return {"params": walk(variables["params"]), "batch_stats": variables["batch_stats"]}


def flat(tree) -> dict:
    return {"/".join(p): v for p, v in _leaves(tree)}


def bf16(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.bfloat16))


def assert_rows_match(got: np.ndarray, ref: np.ndarray, tol: float = ROWS_TOL) -> None:
    """Same (B, max_det, 6) shape, the same valid rows in the same order,
    equal classes, boxes and scores within tol + 1e-6 relative."""
    assert got.shape == ref.shape
    for b in range(len(got)):
        gv, rv = got[b][got[b][:, 4] > 0], ref[b][ref[b][:, 4] > 0]
        assert len(gv) == len(rv) > 0, (b, len(gv), len(rv))
        np.testing.assert_array_equal(gv[:, 5], rv[:, 5])
        np.testing.assert_allclose(gv[:, :5], rv[:, :5], rtol=1e-6, atol=tol)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The small flagship (its YAML says nc 10; the weights have nc 3) with
    spread variables, saved by the JAX package with anchors 1.25 x the
    config's; and JAX's f32 Runner on that file."""
    d = tmp_path_factory.mktemp("ckpt")
    cfg = small_flagship_cfg()
    cfg["nc"] = 10
    _, jmeta, variables = jax_flagship(small_flagship_cfg())
    variables = spread(variables)
    cfg_path = d / "somi-small.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    anchors = (jmeta.anchors_px * 1.25).astype(np.float32)
    weights = d / "w.msgpack"
    jax_ckpt.save_variables(str(weights), variables, anchors=anchors)
    jrunner = jax_runner_mod.Runner(str(cfg_path), str(weights), dtype=jnp.float32, imgsz=IMGSZ)
    images = np.random.default_rng(3).integers(0, 256, (3, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    return dict(dir=d, cfg=str(cfg_path), variables=variables, anchors=anchors, weights=str(weights),
                jrunner=jrunner, images=images)


# ---------------------------------------------------------------------------
# 1. the msgpack codec against flax.serialization
# ---------------------------------------------------------------------------


def _trees():
    """name -> a tree as the JAX package holds it (numpy, bfloat16 from
    ml_dtypes)."""
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 4, 5)).astype(np.float32)
    b16 = bf16(rng.standard_normal((7, 2)))
    return {
        "f32": {"w": f32, "v": np.float32(2.5) * np.ones((70000,), np.float32)},
        "bf16": {"params": {"k": b16, "s": bf16(np.float32(3.0))}},
        "ints": {"i8": np.arange(-5, 5, dtype=np.int8), "u64": np.array([0, 2**63], np.uint64),
                 "i32": rng.integers(-1000, 1000, (4, 4)).astype(np.int32), "n": [0, 127, 128, 255, 256, 65536,
                                                                                 2**40, -1, -32, -33, -129,
                                                                                 -40000, -2**40]},
        "npscalar": {"f": np.float32(1.25), "i": np.int64(-7), "d": np.float64(0.1), "b": np.bool_(True)},
        "nested": {"layers_0": {f"m{i}": {"cv": {"conv": {"kernel": rng.standard_normal((1, 1, 2, i + 1))
                                                          .astype(np.float32)}}} for i in range(20)},
                   "epoch": 300, "best_fitness": 0.5, "step": np.int32(9)},
        "mixed": {"name": "x" * 40, "none": None, "flags": [True, False], "empty": {}, "f64": 1e300,
                  "zero": np.zeros((0, 5), np.float32), "blob": b"\x00\x01" * 200},
    }


TREES = _trees()
BYTES_EQUAL = ("f32", "bf16", "ints", "npscalar", "nested")


def _port_form(tree):
    """Numpy bfloat16 leaves as torch.bfloat16 tensors, the port's way of
    asking for a bfloat16 leaf."""
    if isinstance(tree, dict):
        return {k: _port_form(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype == jnp.bfloat16:
        return torch.tensor(np.asarray(tree, np.float32)).to(torch.bfloat16)
    return tree


def _read_form(tree):
    """What the port reads for a flax tree: bfloat16 widened to float32."""
    if isinstance(tree, dict):
        return {k: _read_form(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.dtype == jnp.bfloat16:
        return np.asarray(tree, np.float32)
    return tree


def _assert_same(a, b):
    if isinstance(b, dict):
        assert isinstance(a, dict) and list(a) == list(b), (list(a), list(b))
        for k in b:
            _assert_same(a[k], b[k])
    elif isinstance(b, (np.ndarray, np.generic)):
        assert type(a) is type(b) or (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)), (type(a), type(b))
        assert a.dtype == b.dtype and np.shape(a) == np.shape(b), (a.dtype, b.dtype, np.shape(a), np.shape(b))
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def _sorted(tree):
    """flax writes a copy whose dict keys jax.tree_util has sorted."""
    return {k: _sorted(tree[k]) for k in sorted(tree)} if isinstance(tree, dict) else tree


@pytest.mark.parametrize("name", sorted(TREES))
def test_port_reads_what_flax_writes(name):
    tree = TREES[name]
    got = msgpack.msgpack_restore(serialization.msgpack_serialize(tree))
    _assert_same(got, _read_form(_sorted(tree)))


@pytest.mark.parametrize("name", sorted(TREES))
def test_flax_reads_what_the_port_writes(name):
    tree = TREES[name]
    _assert_same(serialization.msgpack_restore(msgpack.msgpack_serialize(_port_form(tree))), _sorted(tree))


@pytest.mark.parametrize("name", BYTES_EQUAL)
def test_port_writes_the_bytes_flax_writes(name):
    tree = TREES[name]
    assert msgpack.msgpack_serialize(_port_form(tree)) == serialization.msgpack_serialize(tree)


def test_chunked_leaves_both_ways(monkeypatch):
    """flax writes a leaf over MAX_CHUNK_SIZE bytes (2**30) as a
    `__msgpack_chunked_array__` map. Both limits are lowered to 256 bytes
    here, so that small leaves take that form."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    monkeypatch.setattr(msgpack, "MAX_CHUNK_SIZE", 256)
    rng = np.random.default_rng(1)
    tree = {"big": rng.standard_normal((30, 7)).astype(np.float32), "small": np.arange(3, dtype=np.int64),
            "half": bf16(rng.standard_normal((300,))), "nested": {"k": np.arange(1000, dtype=np.int32)}}
    blob = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in blob
    _assert_same(msgpack.msgpack_restore(blob), _read_form(_sorted(tree)))
    mine = msgpack.msgpack_serialize(_port_form(tree))
    assert mine == blob
    _assert_same(serialization.msgpack_restore(mine), _sorted(tree))
    root = rng.standard_normal((100,)).astype(np.float32)  # a chunked root leaf
    np.testing.assert_array_equal(msgpack.msgpack_restore(serialization.msgpack_serialize(root)), root)


@pytest.mark.parametrize("blob, what", [(b"\x82\xa1a\x01", "truncated"), (b"\x01\x02", "trailing"),
                                        (b"\xc1", "type byte"), (b"\xd4\x07\x00", "extension type")])
def test_reader_refuses_what_is_not_one_msgpack_object(blob, what):
    with pytest.raises(ValueError, match=what):
        msgpack.msgpack_restore(blob)


# ---------------------------------------------------------------------------
# 2. loading the JAX package's files
# ---------------------------------------------------------------------------


def test_runner_loads_a_jax_weights_file_as_jax_does(ckpt):
    jrunner = ckpt["jrunner"]
    runner = Runner(ckpt["cfg"], ckpt["weights"], dtype=torch.float32, device="cpu")
    assert runner.meta.nc == jrunner.meta.nc == NC  # inferred: the YAML says 10
    np.testing.assert_array_equal(runner.meta.anchors_px, ckpt["anchors"])
    np.testing.assert_array_equal(jrunner.meta.anchors_px, ckpt["anchors"])
    images = ckpt["images"]
    for kw in (dict(conf_thres=0.25), dict(conf_thres=0.001, iou_thres=0.6, multi_label=True, exact=True,
                                            max_nms=30000)):
        assert_rows_match(runner(images, **kw), jrunner(images, **kw))
    # the artifact's anchors are in use: the config's decode other boxes
    plain = Runner(ckpt["cfg"], nc=NC, dtype=torch.float32, device="cpu", variables=ckpt["variables"])
    assert not np.allclose(plain.meta.anchors_px, runner.meta.anchors_px)
    assert np.abs(plain(images) - runner(images)).max() > 1.0


def _full_checkpoint(ckpt) -> dict:
    """A training checkpoint's layout (JAX build_checkpoint_payload), whose
    raw params differ from its EMA params."""
    ema = ckpt["variables"]
    raw = jax.tree_util.tree_map(lambda v: v * np.float32(0.5), ema["params"])
    return {"epoch": 7, "best_fitness": 0.25, "anchors": ckpt["anchors"], "params": raw,
            "batch_stats": ema["batch_stats"], "ema_params": ema["params"], "ema_batch_stats": ema["batch_stats"],
            "ema_updates": 70, "step": 70, "opt_state": {"0": {"count": np.int32(70), "mu": raw}}}


def test_full_checkpoint_loads_its_ema_weights(ckpt):
    path = ckpt["dir"] / "last.ckpt"
    payload = _full_checkpoint(ckpt)
    jax_ckpt.write_checkpoint_payload(str(path), payload)
    variables, anchors = checkpoint.load_artifact(path)
    jvariables, janchors = jax_ckpt.load_artifact(str(path))
    np.testing.assert_array_equal(anchors, janchors)
    _assert_same(flat(variables), flat(jvariables))
    _assert_same(flat(variables["params"]), flat(ckpt["variables"]["params"]))
    images = ckpt["images"]
    runner = Runner(ckpt["cfg"], str(path), dtype=torch.float32, device="cpu")
    ema = Runner(ckpt["cfg"], ckpt["weights"], dtype=torch.float32, device="cpu")
    np.testing.assert_array_equal(runner(images), ema(images))
    raw = checkpoint.checkpoint_variables(checkpoint.load_checkpoint(path), ema=False)
    _assert_same(flat(raw["params"]), flat(payload["params"]))
    assert_rows_match(runner(images), ckpt["jrunner"](images))


@pytest.mark.parametrize("which", ["yolo-somi", "yolo-somi-dcn"])
def test_export_gives_back_the_jax_variable_tree(which):
    if which == "yolo-somi":
        cfg = small_flagship_cfg()
        _, _, variables = jax_flagship(cfg)
    else:
        cfg = small_dcn_cfg()
        jmodel, _ = jax_build_model(cfg, nc=NC)
        shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)),
                                                    train=False))
        variables = _to_dict(random_variables(shapes, 1))
    model, _ = build_model(cfg, nc=NC, device="cpu")
    assert load_jax_variables(model, variables) == ([], [])
    back = export_jax_variables(model)
    for collection in ("params", "batch_stats"):
        got, ref = flat(back[collection]), flat(variables[collection])
        assert sorted(got) == sorted(ref)
        for k in ref:
            assert got[k].dtype == np.float32 and got[k].shape == ref[k].shape, k
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _cpu_train_state():
    """The small flagship's train state on the CPU, its momentum buffers
    drawn from seed 0 (the optimizer starts them at zero)."""
    model, _ = build_model(small_flagship_cfg(), nc=NC, device="cpu")
    state = create_train_state(model, make_optimizer(load_hyp(find_config("hyp.visdrone", "hyps")), nb=4, epochs=1,
                                                     batch_size=2))
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for buf in state.opt_state.momentum_buf:
            buf.copy_(torch.randn(buf.shape, generator=gen))
    return state


def _live_tensors(state) -> list:
    """Every tensor a train step or the EMA updates in place."""
    return [*state.model.state_dict().values(), *state.ema.ema.state_dict().values(), *state.opt_state.momentum_buf]


def test_export_shares_no_memory_with_the_model():
    """export_jax_variables and export_param_tree hand out copies: a leaf
    that viewed a contiguous float32 CPU tensor (a bias, a BatchNorm
    statistic, a momentum buffer) would change under the next step."""
    state = _cpu_train_state()
    model = state.model
    exported = [v for tree in (export_jax_variables(model), export_jax_variables(state.ema.ema),
                               export_param_tree(model, state.names, state.opt_state.momentum_buf))
                for _, v in _leaves(tree)]
    live = [t.numpy() for t in _live_tensors(state)]
    assert len(exported) > 500
    shared = [i for i, v in enumerate(exported) if any(np.may_share_memory(v, t) for t in live)]
    assert not shared, f"{len(shared)} of {len(exported)} exported leaves view the model's state"


def test_async_checkpointer_writes_the_state_at_save(tmp_path, monkeypatch):
    """AsyncCheckpointer.save copies the state to the host before it
    returns: in-place updates of the model, its EMA and the momentum
    buffers made while the writer thread waits do not reach the file."""
    state = _cpu_train_state()
    frozen = copy.deepcopy(state)
    gate = threading.Event()
    write = checkpoint.write_checkpoint_payload

    def held_write(*args, **kwargs):
        assert gate.wait(60)
        write(*args, **kwargs)

    monkeypatch.setattr(checkpoint, "write_checkpoint_payload", held_write)
    writer = checkpoint.AsyncCheckpointer()
    try:
        writer.save(tmp_path / "a.ckpt", state, epoch=1)
        with torch.no_grad():  # what the next train step and EMA update do
            for t in _live_tensors(state):
                if t.is_floating_point():
                    t.add_(1.0)
        gate.set()
        writer.wait()
    finally:
        gate.set()
        writer.close()
    got = checkpoint.load_checkpoint(tmp_path / "a.ckpt")
    want = checkpoint.build_checkpoint_payload(frozen, epoch=1)
    trees = [(got[k], want[k]) for k in ("params", "batch_stats", "ema_params", "ema_batch_stats")]
    for got_tree, want_tree in trees + [(got["opt_state"]["momentum_buf"], want["opt_state"]["momentum_buf"])]:
        g, w = flat(got_tree), flat(want_tree)
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_a_port_written_file_loads_in_both_packages(ckpt):
    model = Runner(ckpt["cfg"], ckpt["weights"], dtype=torch.float32, device="cpu").model
    path = ckpt["dir"] / "port.msgpack"
    checkpoint.save_variables(path, export_jax_variables(model), meta_dict={"epoch": 3}, anchors=ckpt["anchors"])
    jvariables, janchors = jax_ckpt.load_artifact(str(path))
    np.testing.assert_array_equal(janchors, ckpt["anchors"])
    ref = flat(ckpt["variables"])
    got = flat(jax.tree_util.tree_map(np.asarray, jvariables))
    assert sorted(got) == sorted(ref) and all(np.array_equal(got[k], ref[k]) for k in ref)
    assert yaml.safe_load(path.with_suffix(".json").read_text()) == {"epoch": 3}
    jrunner = jax_runner_mod.Runner(ckpt["cfg"], str(path), dtype=jnp.float32, imgsz=IMGSZ)
    assert_rows_match(Runner(ckpt["cfg"], str(path), dtype=torch.float32, device="cpu")(ckpt["images"]),
                      jrunner(ckpt["images"]))


@pytest.mark.parametrize("half", [True, False])
def test_strip_checkpoint_writes_jax_bytes_and_loads_the_same_model(ckpt, half):
    src = ckpt["dir"] / "strip-src.ckpt"
    jax_ckpt.write_checkpoint_payload(str(src), _full_checkpoint(ckpt))
    mine, theirs = ckpt["dir"] / f"port-{half}.msgpack", ckpt["dir"] / f"jax-{half}.msgpack"
    checkpoint.strip_checkpoint(src, mine, half=half)
    jax_ckpt.strip_checkpoint(str(src), str(theirs), half=half)
    assert mine.read_bytes() == theirs.read_bytes()
    if not half:
        return
    # the bf16 file gives the bf16 model the f32 file gives, bit for bit
    stripped = Runner(ckpt["cfg"], str(mine), dtype=torch.bfloat16, device="cpu")
    full = Runner(ckpt["cfg"], ckpt["weights"], dtype=torch.bfloat16, device="cpu")
    np.testing.assert_array_equal(stripped.meta.anchors_px, ckpt["anchors"])
    for (k, a), (_, b) in zip(stripped.model.state_dict().items(), full.model.state_dict().items()):
        assert a.dtype == b.dtype and torch.equal(a, b), k
    # and the JAX package reads the same bf16 values from it
    jvars = flat(jax.tree_util.tree_map(lambda v: np.asarray(v, np.float32), jax_ckpt.load_variables(str(theirs))))
    exported = flat(export_jax_variables(stripped.model))
    assert sorted(jvars) == sorted(exported) and all(np.array_equal(jvars[k], exported[k]) for k in jvars)
    np.testing.assert_array_equal(stripped(ckpt["images"]), full(ckpt["images"]))


def test_missing_weights_warn_and_use_the_seed(ckpt, tmp_path):
    missing = tmp_path / "missing.msgpack"
    runner, lines = _run_logged(Runner, LOGGER, cfg=ckpt["cfg"], weights=str(missing), dtype=torch.float32,
                                device="cpu", seed=0)
    assert any("not found" in line and "seed 0" in line for line in lines), lines
    seeded = Runner(ckpt["cfg"], dtype=torch.float32, device="cpu", seed=0)
    assert runner.meta.nc == 10  # nothing to infer nc from
    for a, b in zip(runner.model.state_dict().values(), seeded.model.state_dict().values()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# 3. val.run from a weights file
# ---------------------------------------------------------------------------

VAL_SIZES = [(64, 64), (48, 64), (64, 40), (80, 60), (64, 64), (50, 70)]
VAL_BATCH = 4  # 6 images: the last batch wraps 2


@pytest.fixture(scope="module")
def labelled(ckpt):
    """6 synthetic PNGs labelled with the JAX Runner's top 5 single-label
    detections (conf > 0.25) of the weights file; the data YAML's path."""
    root = ckpt["dir"] / "ds"
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(4)
    for i, (h, w) in enumerate(VAL_SIZES):
        _write_image(root / "images" / f"im{i}.png", rng, h, w)
    dataset = jax_datasets.DetectionDataset(str(root / "images"), img_size=IMGSZ, batch_size=VAL_BATCH)
    n_labels = 0
    for images, _, paths, shapes in jax_datasets.DataLoader(dataset, VAL_BATCH, shuffle=False):
        out = ckpt["jrunner"](images, conf_thres=0.25)
        for det, path, ((h0, w0), ratio_pad) in zip(out, paths, shapes):
            det = det[det[:, 4] > 0][:5]
            xyxy = np.asarray(jax_boxes.scale_coords(images.shape[1:3], det[:, :4], (h0, w0), ratio_pad))
            xywhn = np.asarray(jax_boxes.xyxy2xywhn(xyxy, w=w0, h=h0))
            rows = [f"{int(c)} " + " ".join(f"{v:.6f}" for v in b) for c, b in zip(det[:, 5], xywhn)
                    if (b[2:] > 0).all()]
            lb = root / "labels" / (path.rsplit("/", 1)[-1].rsplit(".", 1)[0] + ".txt")
            if not lb.exists():
                lb.write_text("\n".join(rows) + "\n" if rows else "")
                n_labels += len(rows)
    assert n_labels >= 10, n_labels
    data = root / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(root), "train": "images", "val": "images", "nc": NC,
                                    "names": ["a", "b", "c"]}))
    return str(data)


def test_val_run_from_a_weights_file_matches_jax(ckpt, labelled, tmp_path, monkeypatch):
    """JAX's val.run builds its Runner in bfloat16; it is made float32 here
    (a test-side monkeypatch of the Runner JAX's val.py calls), so both
    packages run the same file in float32."""
    monkeypatch.setattr(jax_val, "Runner", lambda *a, **k: jax_runner_mod.Runner(*a, dtype=jnp.float32, **k))
    common = dict(data=labelled, weights=ckpt["weights"], cfg=ckpt["cfg"], batch_size=VAL_BATCH, imgsz=IMGSZ,
                  project=str(tmp_path), exist_ok=True)
    (jres, jmaps, _), jlines = _run_logged(jax_val.run, jax_val.LOGGER, name="jax", **common)
    (pres, pmaps, _), plines = _run_logged(val.run, val.LOGGER, name="port", half=False, device="cpu", **common)
    assert jres[2] > 0.5, f"JAX mAP@.5 {jres[2]} on its own labels: the check would be vacuous"
    assert abs(pres[2] - jres[2]) <= 1e-3 and abs(pres[3] - jres[3]) <= 1e-3, (pres[:4], jres[:4])
    np.testing.assert_allclose(pmaps, jmaps, atol=1e-3)
    assert _table(plines) == _table(jlines) and _table(plines)[0][:2] == ("all", str(len(VAL_SIZES)))
    assert val.parse_opt(["--weights", ckpt["weights"]]).weights == ckpt["weights"]


# ---------------------------------------------------------------------------
# 4. bfloat16 BatchNorm
# ---------------------------------------------------------------------------


def test_bf16_batchnorm_stays_within_jax_own_bf16_distance():
    """The port's rule: build_model casts the whole model, BatchNorm's
    running statistics and affine parameters included, to bfloat16, and
    BatchNorm runs in bfloat16 (ATen upcasts each element to float32
    inside the op and rounds its output once). Flax keeps the statistics in
    float32 and normalizes in float32. The port's bfloat16 output must lie
    within twice JAX's own bfloat16-to-float32 distance of JAX's float32
    output, on the randomized fixture as it is."""
    cfg = small_flagship_cfg()
    jmodel32, _, variables = jax_flagship(cfg)
    jmodel16, _ = jax_build_model(cfg, nc=NC, dtype=jnp.bfloat16)
    x = np.random.default_rng(6).random((2, IMGSZ, IMGSZ, 3), np.float32)
    ref = [np.asarray(o, np.float32) for o in jax.jit(lambda v, t: jmodel32.apply(v, t, False))(variables, x)]
    j16 = [np.asarray(o, np.float32) for o in jax.jit(lambda v, t: jmodel16.apply(v, t, False))(variables, x)]
    model, _ = build_model(cfg, nc=NC, device="cpu", dtype=torch.bfloat16)
    assert load_jax_variables(model, variables) == ([], [])
    assert all(b.dtype == torch.bfloat16 for k, b in model.state_dict().items() if "running" in k)
    with torch.no_grad():
        p16 = [o.float().numpy() for o in model(torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16))]
    jax_dist = max(np.abs(a - r).max() for a, r in zip(j16, ref))
    port_dist = max(np.abs(a - r).max() for a, r in zip(p16, ref))
    assert 0 < jax_dist and math.isfinite(port_dist)
    assert port_dist <= 2 * jax_dist, (port_dist, jax_dist)
