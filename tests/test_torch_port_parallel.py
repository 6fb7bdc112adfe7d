"""yolosomi_tpu_torch's data parallelism (parallel/mesh.py and its wiring)
against the JAX package's 2-device mesh, on the CPU.

The invariant: a step on 2 ranks, each holding its half of a global
batch, is JAX's mesh step on the global batch (which is its one-device
step): global BatchNorm statistics, the loss's global normalisers, summed
gradients, one finite-guard decision. The port's ranks are processes
spawned by parallel.mesh.spawn_local over gloo with one thread each; their
functions live in tests/_torch_parallel_ranks.py, which imports no jax, so
a rank never loads JAX. JAX runs here, on two of conftest.py's eight
virtual CPU devices (create_mesh(devices=jax.devices()[:2])). One spawn
runs every rank-side case (spawn_local's timeout fails a hung rank).

Sizes: yolov5n (nc 4, 64 px; the setup of JAX's
test_multistep_sharded_matches_single_device), the small flagship for the
train.run case. Tolerances (JAX's own for its mesh, tests/test_sharding.py:
205-218): losses within 2e-4 relative; parameters and EMA within 5e-3
relative plus 3e-3 absolute; the BatchNorm module within 1e-5.
"""

import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import flax.linen as fnn

from tests import _torch_parallel_ranks as ranks
from tests._torch_port_common import few_threads, small_flagship_cfg  # noqa: F401
from yolosomi_tpu.engine.optim import make_optimizer as jax_make_optimizer
from yolosomi_tpu.engine.trainer import create_train_state as jax_create_train_state
from yolosomi_tpu.engine.trainer import make_train_step as jax_make_train_step
from yolosomi_tpu.losses import ComputeLoss as JaxComputeLoss
from yolosomi_tpu.models.yolo import build_model as jax_build_model, init_model
from yolosomi_tpu.parallel.mesh import create_mesh, replicate_tree, shard_batch as jax_shard_batch
from yolosomi_tpu.utils.config import DEFAULT_HYP, find_config, load_model_cfg
from yolosomi_tpu_torch import train
from yolosomi_tpu_torch.data.datasets import DataLoader, DetectionDataset, pad_targets
from yolosomi_tpu_torch.parallel import mesh
from yolosomi_tpu_torch.utils.config import find_config as port_find_config, load_hyp

NC, IMGSZ, WORLD = 4, 64, 2
NAN_ROWS = slice(4, 8)  # rank 1's half of the b8 batch
BN_MOMENTUM, BN_EPS = 0.1, 1e-5  # ODConv's attention-trunk BatchNorm1d


def v5n_cfg() -> dict:
    cfg = dict(load_model_cfg(find_config("yolov5n")))
    cfg["nc"] = NC
    return cfg


def batch8():
    """JAX's multistep test batch: b8 of noise, one box an image."""
    rng = np.random.default_rng(3)
    images = rng.standard_normal((8, IMGSZ, IMGSZ, 3)).astype(np.float32)
    labels = [np.array([[i % 4, 0.5, 0.5, 0.3, 0.3]], np.float32) for i in range(8)]
    return images, pad_targets(labels, 4)


def batch2_targets_on_rank0():
    """b2, one image a rank; every target on image 0 (rank 0), none on rank 1."""
    rng = np.random.default_rng(4)
    images = rng.standard_normal((2, IMGSZ, IMGSZ, 3)).astype(np.float32)
    labels = [np.array([[1, 0.5, 0.5, 0.3, 0.3], [2, 0.3, 0.6, 0.2, 0.25], [3, 0.7, 0.3, 0.1, 0.15]], np.float32),
              np.zeros((0, 5), np.float32)]
    return images, pad_targets(labels, 4)


SLIDE_NWD = dict(slide_ratio=1, nwdloss=1)
ACC = 2


def write_set(root: Path, n: int) -> Path:
    (root / "images").mkdir(parents=True)
    (root / "labels").mkdir()
    rng = np.random.default_rng(0)
    for i in range(n):
        h, w = (72, 96) if i % 2 else (100, 80)
        cv2.imwrite(str(root / "images" / f"{i}.jpg"), rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        rows = [f"{rng.integers(0, 3)} {rng.uniform(.2, .8):.6f} {rng.uniform(.2, .8):.6f} "
                f"{rng.uniform(.05, .4):.6f} {rng.uniform(.05, .4):.6f}" for _ in range(1 + rng.integers(0, 4))]
        (root / "labels" / f"{i}.txt").write_text("\n".join(rows))
    return root / "images"


@pytest.fixture(scope="module")
def v5n():
    """yolov5n's flax model, meta and init_model variables (numpy)."""
    model, meta = jax_build_model(v5n_cfg(), nc=NC)
    return model, meta, jax.tree_util.tree_map(np.asarray, jax.device_get(init_model(model, meta, imgsz=IMGSZ)))


@pytest.fixture(scope="module")
def jax_runs(v5n, spawned):
    """JAX's 2-device mesh steps from init_model's variables: (a) default
    hyp, b8, three steps and then a batch whose rank-1 half is NaN; (b)
    SlideLoss and NWD on, --accumulate 2, b2 with every target on rank 0,
    four calls. Both programs compile on threads of their own, while the
    port's ranks run (`spawned`)."""
    model, meta, variables = v5n
    mesh2 = create_mesh(devices=jax.devices()[:WORLD])
    cases = {"a": (dict(DEFAULT_HYP), 1, batch8()), "b": (dict(DEFAULT_HYP, **SLIDE_NWD), ACC,
                                                         batch2_targets_on_rank0())}

    def program(case):
        hyp, acc, (images, targets) = cases[case]
        opt = jax_make_optimizer(hyp, nb=4, epochs=2, batch_size=len(images), accumulate=acc)
        state = jax_create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), opt, accumulate=acc)
        step = jax_make_train_step(model, JaxComputeLoss(meta, hyp), opt, mesh=mesh2, accumulate=acc)
        with mesh2:
            state = replicate_tree(state, mesh2)
            b = jax_shard_batch({"images": images, "targets": targets}, mesh2)
            compiled = step.lower(state, b["images"], b["targets"]).compile({"xla_backend_optimization_level": 0})
        return state, compiled

    with ThreadPoolExecutor(2) as pool:
        programs = dict(zip(cases, pool.map(program, cases)))

    def run(case, batches):
        state, step = programs[case]
        out = []
        with mesh2:
            for images, targets in batches:
                b = jax_shard_batch({"images": images, "targets": targets}, mesh2)
                state, m = step(state, b["images"], b["targets"])
                s = jax.device_get(state)
                out.append(dict(metrics={k: float(v) for k, v in jax.device_get(m).items()},
                                params=ranks.flat(s.params), batch_stats=ranks.flat(s.batch_stats),
                                ema=ranks.flat(s.ema.variables["params"]), opt_step=int(s.opt_state.step)))
        return out

    images, targets = batch8()
    nan = images.copy()
    nan[NAN_ROWS] = np.nan
    return dict(a=run("a", [(images, targets)] * 3 + [(nan, targets)]), b=run("b", [batch2_targets_on_rank0()] * 4))


@pytest.fixture(scope="module")
def spawned(v5n, tmp_path_factory):
    """Every rank-side case in one spawn of 2 gloo ranks, started on a
    thread (a Future of port_ranks' dict): the two step runs from JAX's
    variables, the BatchNorm module at one row a rank, the float64 step and
    distillation loss of the small flagship, and one epoch of train.run of
    it."""
    tmp = tmp_path_factory.mktemp("dp")
    images = write_set(tmp / "ds", 8)
    data = tmp / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(tmp / "ds"), "train": str(images), "val": str(images), "nc": 3,
                                    "names": ["a", "b", "c"]}))
    cfg = tmp / "somi-small.yaml"
    cfg.write_text(yaml.safe_dump(small_flagship_cfg()))
    nan_images, targets = batch8()
    nan_images = nan_images.copy()
    nan_images[NAN_ROWS] = np.nan
    common = dict(cfg=v5n_cfg(), nc=NC, variables=v5n[2])
    calls = [
        (ranks.train_steps, dict(common, hyp=dict(DEFAULT_HYP), opt_kw=dict(nb=4, epochs=2, batch_size=8),
                                 batches=[batch8()] * 3 + [(nan_images, targets)])),
        (ranks.train_steps, dict(common, hyp=dict(DEFAULT_HYP, **SLIDE_NWD), accumulate=ACC,
                                 opt_kw=dict(nb=4, epochs=2, batch_size=2), batches=[batch2_targets_on_rank0()] * 4)),
        (ranks.bn_global, dict(x=bn_input(), momentum=BN_MOMENTUM, eps=BN_EPS)),
        (ranks.step_grads, dict(cfg=small_flagship_cfg(), nc=3, hyp=dict(DEFAULT_HYP), images=f64_batch()[0],
                                targets=f64_batch()[1])),
        (ranks.distill_grads, dict(cfg=small_flagship_cfg(), nc=3, hyp=dict(DEFAULT_HYP), images=f64_batch()[0],
                                   targets=f64_batch()[1])),
        (ranks.train_run, dict(kwargs=dict(cfg=str(cfg), data=str(data), epochs=1, batch_size=4, imgsz=IMGSZ,
                                           device="cpu", no_bf16=True, workers=1, max_labels=16, sync_bn=True,
                                           project=str(tmp / "runs"), name="t"))),
        (ranks.step_grads, dict(cfg=v8_cfg(), nc=3, hyp=dict(DEFAULT_HYP), images=f64_batch()[0],
                                targets=f64_batch()[1], v8=True)),
    ]

    def run():
        results = mesh.spawn_local(WORLD, ranks.run_calls, calls, timeout=240)
        return dict(a=[r[0] for r in results], b=[r[1] for r in results], bn=[r[2] for r in results],
                    f64=[r[3] for r in results], distill=[r[4] for r in results], run=[r[5] for r in results],
                    v8=[r[6] for r in results], runs_dir=tmp / "runs")

    pool = ThreadPoolExecutor(1)
    future = pool.submit(run)
    yield future
    pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def port_ranks(spawned):
    return spawned.result()


def assert_losses_close(got: list, want: list) -> None:
    for g, w in zip(got, want):
        for k in ("loss", "lbox", "lobj", "lcls"):
            np.testing.assert_allclose(g["metrics"][k], w["metrics"][k], rtol=2e-4, err_msg=k)
        assert g["metrics"]["grads_finite"] == w["metrics"]["grads_finite"]


def assert_states_close(got: dict, want: dict) -> None:
    for coll in ("params", "ema"):
        assert set(got[coll]) == set(want[coll])
        for k, v in want[coll].items():
            np.testing.assert_allclose(got[coll][k], v, rtol=5e-3, atol=3e-3, err_msg=f"{coll}/{k}")
    assert got["opt_step"] == want["opt_step"]


def assert_ranks_equal(per_rank: list) -> None:
    """Every rank holds the same bits: metrics, parameters, statistics, EMA."""
    for other in per_rank[1:]:
        for g, w in zip(other, per_rank[0]):
            assert g["metrics"].keys() == w["metrics"].keys()
            np.testing.assert_array_equal(list(g["metrics"].values()), list(w["metrics"].values()))
            for coll in ("params", "batch_stats", "ema"):
                for k, v in w[coll].items():
                    np.testing.assert_array_equal(g[coll][k], v, err_msg=f"{coll}/{k}")


def test_three_yolov5n_steps_on_two_ranks_match_the_jax_mesh(jax_runs, port_ranks):
    """JAX's multistep setup: losses of each step, parameters and EMA after
    three steps against the 2-device mesh; both ranks the same bits."""
    got, want = port_ranks["a"][0][:3], jax_runs["a"][:3]
    assert_losses_close(got, want)
    assert all(g["metrics"]["grads_finite"] == 1.0 for g in got)
    assert_states_close(got[-1], want[-1])
    assert got[-1]["opt_step"] == 3
    assert_ranks_equal(port_ranks["a"])


def test_a_nan_gradient_on_one_rank_skips_the_step_on_both(jax_runs, port_ranks):
    """Rank 1's half of the batch is NaN: the summed gradients are not
    finite on either rank, so neither moves a parameter, a statistic, the
    EMA or the optimizer step, as JAX's guard on the global batch."""
    assert jax_runs["a"][3]["metrics"]["grads_finite"] == 0.0
    for rank in port_ranks["a"]:
        before, after = rank[2], rank[3]
        assert after["metrics"]["grads_finite"] == 0.0 and after["opt_step"] == before["opt_step"] == 3
        for coll in ("params", "batch_stats", "ema"):
            for k, v in before[coll].items():
                np.testing.assert_array_equal(after[coll][k], v, err_msg=f"{coll}/{k}")
    assert_ranks_equal(port_ranks["a"])


def test_targets_on_one_rank_use_the_global_normalisers(jax_runs, port_ranks):
    """SlideLoss and NWD on, every target on rank 0, one image a rank, with
    --accumulate 2: the positives, the IoU sum behind auto_iou and the batch
    size are the global batch's, so the losses and the state after four
    calls (two optimizer steps) are the JAX mesh's."""
    got, want = port_ranks["b"][0], jax_runs["b"]
    assert_losses_close(got, want)
    assert [g["opt_step"] for g in got] == [w["opt_step"] for w in want] == [0, 1, 1, 2]
    assert [g["ema_updates"] for g in got] == [0, 1, 1, 2]
    for g, w in zip(got, want):
        assert_states_close(g, w)
    assert_ranks_equal(port_ranks["b"])


def bn_input() -> np.ndarray:
    return np.random.default_rng(7).standard_normal((WORLD, 6)).astype(np.float32) * 2 + 0.5


def test_batchnorm_at_one_value_a_channel_a_rank_is_flax_on_the_global_batch(port_ranks):
    """ODConv's trunk BatchNorm1d at one image a rank (one value a channel,
    which torch's batch_norm refuses alone): the output, the input, scale
    and bias gradients of a loss that differs by rank, and the running
    statistics are flax's BatchNorm over both rows, computed in float64,
    within 1e-5 relative plus 1e-5 absolute (statistics 1e-6). With two
    values a channel the input gradient is a difference of nearly equal
    terms: flax's own f32 gradient lies 1.0e-5 from its float64 one, the
    port's 6.7e-6 (measured)."""
    x = bn_input()
    c = x.shape[1]
    with jax.enable_x64(True):
        bn = fnn.BatchNorm(use_running_average=False, momentum=1 - BN_MOMENTUM, epsilon=BN_EPS, dtype=jnp.float64,
                           param_dtype=jnp.float64)
        x64 = jnp.asarray(x, jnp.float64)
        variables = bn.init(jax.random.PRNGKey(0), x64)
        params = {"scale": jnp.linspace(0.5, 1.5, c, dtype=jnp.float64),
                  "bias": jnp.linspace(-0.2, 0.2, c, dtype=jnp.float64)}
        w_out = jnp.arange(1, x.shape[0] + 1, dtype=jnp.float64)[:, None]

        def loss(p, x_):
            y, upd = bn.apply({"params": p, "batch_stats": variables["batch_stats"]}, x_, mutable=["batch_stats"])
            return (y * w_out).sum(), (y, upd)

        (_, (y, upd)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(params, x64)
        y, upd, gp, gx = jax.device_get((y, upd, gp, gx))
    for r, got in enumerate(port_ranks["bn"]):
        np.testing.assert_allclose(got["y"], y[r:r + 1], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["gx"], gx[r:r + 1], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["gw"], gp["scale"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["gb"], gp["bias"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got["mean"], upd["batch_stats"]["mean"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got["var"], upd["batch_stats"]["var"], rtol=1e-5, atol=1e-6)


def f64_batch():
    """b4 of uint8 images at 64 px, targets on three of them."""
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (4, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    labels = [np.array([[i % 3, 0.3 + 0.1 * i, 0.5, 0.3, 0.2]], np.float32) for i in range(3)] + [np.zeros((0, 5))]
    return images, pad_targets(labels, 4)


def test_two_ranks_are_the_one_process_step_in_float64(port_ranks):
    """The semantics alone, without f32's rounding: the small flagship
    (ODConv's trunk BatchNorm1d at two images a rank, SEAM, CBAM, the
    decoupled head) in float64, one train-mode forward, loss and backward
    on 2 ranks against one process on the global b4: the loss within
    1e-6 relative and every gradient within 1e-6 relative norm plus 1e-9
    of the largest gradient's norm. ComputeLoss takes the maps in f32, so
    the loss and the maps' gradient round at f32's 6e-8 (measured: the
    gradients a median 5e-13 apart, ODConv's bias bank 5e-8); in f32 the
    two runs lie a median 3e-4 apart, which this graph's backward makes of
    f32 rounding. A lost normaliser or an unreduced statistic moves them
    by percents."""
    images, targets = f64_batch()
    assert_global_grads(port_ranks["f64"], ranks.step_grads(None, small_flagship_cfg(), 3, dict(DEFAULT_HYP),
                                                            images, targets))


def test_distillation_on_two_ranks_is_the_one_process_loss_in_float64(port_ranks):
    """The distillation loss (a confident teacher, alpha 1, hint 0.5 with
    the FitNets adapters) as the float64 test above: its batch size, its
    means and the normalisers of kd_cls, kd_box and the hint are the global
    batch's, so the ranks' loss and gradients, adapters included, are one
    process's on the global b4 (the same limits)."""
    images, targets = f64_batch()
    want = ranks.distill_grads(None, small_flagship_cfg(), 3, dict(DEFAULT_HYP), images, targets)
    assert any(k.startswith("kd_adapter_") and np.abs(g).max() > 0 for k, g in want["grads"].items())
    assert_global_grads(port_ranks["distill"], want)


def v8_cfg() -> dict:
    """The small flagship under DetectV8 on its P2-P5 maps."""
    cfg = small_flagship_cfg()
    cfg["head"] = cfg["head"][:-1] + [[[25, 28, 31, 34], 1, "DetectV8", ["nc"]]]
    return cfg


def test_the_v8_loss_on_two_ranks_is_the_one_process_step_in_float64(port_ranks):
    """ComputeLossV8 as the float64 test above (the same limits): each
    image's assignment is its own, and the target-score sum that
    normalises every term is the global batch's, summed over the ranks
    with its gradient; the batch size is the global one."""
    images, targets = f64_batch()
    want = ranks.step_grads(None, v8_cfg(), 3, dict(DEFAULT_HYP), images, targets, v8=True)
    assert_global_grads(port_ranks["v8"], want)


def assert_global_grads(per_rank: list, want: dict) -> None:
    top = max(np.linalg.norm(g) for g in want["grads"].values())
    for got in per_rank:
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        assert set(got["grads"]) == set(want["grads"])
        for k, w in want["grads"].items():
            d = np.linalg.norm(got["grads"][k] - w)
            assert d <= 1e-6 * np.linalg.norm(w) + 1e-9 * top, (k, d, np.linalg.norm(w))
    for k, g in per_rank[1]["grads"].items():
        np.testing.assert_array_equal(g, per_rank[0]["grads"][k], err_msg=k)


def test_train_run_on_two_ranks_writes_each_file_once(port_ranks):
    """One epoch of train.run of the small flagship (64 px, global b4,
    autoanchor on rank 0, --sync-bn accepted): both ranks end with the same
    parameters, statistics, EMA and fitness, and the run's files exist once
    (one run directory, one results row, one log line)."""
    a, b = port_ranks["run"]
    assert (a["rank"], b["rank"]) == (0, 1) and a["fitness"] == b["fitness"]
    assert a["opt_step"] == b["opt_step"] == 2
    for coll in ("params", "batch_stats", "ema"):
        for k, v in a[coll].items():
            np.testing.assert_array_equal(b[coll][k], v, err_msg=f"{coll}/{k}")
    runs = port_ranks["runs_dir"]
    assert sorted(p.name for p in runs.iterdir()) == ["t"]
    run = runs / "t"
    assert len((run / "results.csv").read_text().splitlines()) == 2
    log = [json.loads(line) for line in (run / "train_log.jsonl").read_text().splitlines()]
    assert len(log) == 1 and log[0]["steps"] == 2 and log[0]["skipped_logged"] == 0
    assert sorted(p.name for p in (run / "weights").iterdir()) == ["best.ckpt", "best.msgpack", "last.ckpt",
                                                                   "last.msgpack"]


# ---------------------------------------------------------------------------
# the loader's rank slices (no spawn: the loader is host code)
# ---------------------------------------------------------------------------

LOADER_CASES = {
    "shuffle": dict(shuffle=True),
    "image_weights": dict(shuffle=True, weights=True),
    "rect": dict(rect=True),
    "quad": dict(shuffle=True, quad=True),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loader_rank_slices_concatenate_to_the_one_process_batch(tmp_path, case):
    """Two epochs of a global batch of 8 over 2 ranks: each rank's images,
    targets and paths are its half of the one-process batch (quad: its
    half of the quad images, whole groups of 4, with the same coin
    flips; the paths of a quad batch are those of its first B / 4 items,
    so each rank's are of its own), and a rect batch keeps the global
    batch's shape (at 128 px: at 64 every rect batch of this set is
    square)."""
    kw = LOADER_CASES[case]
    images = write_set(tmp_path / "ds", 20)
    size = 2 * IMGSZ if case == "rect" else IMGSZ
    ds = DetectionDataset(str(images), img_size=size, rect=kw.get("rect", False), batch_size=8, max_labels=16)

    def epochs(rank, world):
        loader = DataLoader(ds, 8, shuffle=kw.get("shuffle", False), drop_last=True, seed=5, workers=1, prefetch=0,
                            quad=kw.get("quad", False), rank=rank, world=world)
        if kw.get("weights"):
            loader.sample_weights = np.linspace(0.1, 2.0, len(ds))
        return [b for _ in range(2) for b in loader]

    one, parts = epochs(0, 1), [epochs(r, WORLD) for r in range(WORLD)]
    assert len(one) == 4 and all(len(p) == 4 for p in parts)
    for i, want in enumerate(one):
        got = [p[i] for p in parts]
        np.testing.assert_array_equal(np.concatenate([g[0] for g in got]), want[0])
        np.testing.assert_array_equal(np.concatenate([g[1] for g in got]), want[1])
        if case != "quad":
            assert sum((g[2] for g in got), []) == want[2]
        assert len(got[0][0]) == len(want[0]) // WORLD
    if case == "quad":
        assert one[0][0].shape[1:3] == (2 * IMGSZ, 2 * IMGSZ) and len(one[0][0]) == 2
    if case == "rect":
        assert {b[0].shape[1:3] for b in one} != {(size, size)}


def test_ranks_take_their_rows_of_the_device_mosaic_and_preprocess(tmp_path):
    """--cache device with the device preprocess: every rank gets the
    global batch's plan and targets from its loader (the same draws as one
    process), and the step's inputs on rank r are rows [4r, 4r + 4) of the
    one-process step's, images and targets, HSV gains and flips drawn for
    the global batch."""
    from types import SimpleNamespace

    from yolosomi_tpu_torch.engine.trainer import TrainStep
    from yolosomi_tpu_torch.ops.mosaic_device import build_device_cache

    hyp = dict(load_hyp(port_find_config("hyp.visdrone", "hyps")), mixup=0.5, fliplr=0.5, flipud=0.5)
    ds = DetectionDataset(str(write_set(tmp_path / "ds", 12)), img_size=IMGSZ, augment=True, hyp=hyp,
                          max_labels=16)
    slab = torch.from_numpy(build_device_cache(ds)[0])
    state = SimpleNamespace(params=[torch.zeros(1)], step=5)

    def inputs(rank, world):
        import random

        random.seed(1)
        np.random.seed(1)
        plan, targets, _, _ = next(iter(DataLoader(ds, 8, shuffle=True, prefetch=0, plan=True, rank=rank,
                                                   world=world)))
        group = mesh.DataGroup(rank, world, torch.device("cpu")) if world > 1 else None
        step = TrainStep(None, None, device_preprocess=dict(hyp, seed=3), device_mosaic=IMGSZ, group=group)
        return step.inputs(state, (slab, plan), targets)

    x, t = inputs(0, 1)
    for r in range(WORLD):
        xr, tr = inputs(r, WORLD)
        torch.testing.assert_close(xr, x[4 * r:4 * r + 4], rtol=0, atol=0)
        torch.testing.assert_close(tr, t[4 * r:4 * r + 4], rtol=0, atol=0)


def test_loader_refuses_a_batch_that_does_not_split():
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        DataLoader([], 8, rank=0, world=3)


def test_train_refuses_a_global_batch_that_does_not_split(tmp_path, monkeypatch):
    """--batch-size is the global batch: it must divide by the ranks (and
    by 4 x the ranks under --quad)."""
    group = mesh.DataGroup(0, 3, torch.device("cpu"))
    monkeypatch.setattr(mesh, "init_data_parallel", lambda: group)
    opt = train.parse_opt(["--project", str(tmp_path), "--device", "cpu", "--batch-size", "8"])
    with pytest.raises(ValueError, match="must divide by 3 ranks"):
        train.train(load_hyp(port_find_config("hyp.visdrone", "hyps")), opt)


# ---------------------------------------------------------------------------
# spawn_local's failures: a failed or hung rank fails the call, never the suite
# ---------------------------------------------------------------------------


def test_a_failing_rank_stops_every_rank_and_raises_its_traceback():
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose") as err:
        mesh.spawn_local(WORLD, ranks.fail_on, 1, timeout=60)
    assert "(1, 1)" in str(err.value)


def test_a_hung_rank_is_stopped_at_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="after the timeout"):
        mesh.spawn_local(WORLD, ranks.hang, 300, timeout=6)
    assert time.monotonic() - t0 < 60
