"""yolosomi_tpu_torch's pipeline parallelism (parallel/pipeline.py) against
the JAX package's (yolosomi_tpu/parallel/pipeline.py), on the CPU: every
stage on `cpu`, as JAX's stages on conftest.py's virtual CPU devices.

Sizes: yolov5n (nc 4, 64 px; the setup of JAX's pipeline tests,
tests/test_sharding.py:269-400) and the flagship graph at width 0.25 /
depth 0.33 for the stage partition. Tolerances (JAX's own,
tests/test_sharding.py:370-385): pipeline_infer within 1e-5 relative plus
1e-5 absolute; PipelineTrainer's loss within 1e-5 relative; the
partition exactly. The pipeline's step against the port's own one-process
step: the same bits (the same operations in the same order).

PipelineTrainer's gradients against JAX's value_and_grad: each leaf within
5e-4 of its largest element. JAX holds its pipeline to its own
value_and_grad at 1e-3 relative plus 1e-4 absolute per element, two XLA
programs that mostly sum alike. Torch on the CPU and XLA sum differently,
and yolov5n's backward at init on this batch amplifies f32 rounding: the
port's one-process gradients (which the pipeline's equal bit for bit) lie
up to 2.2e-4 of a leaf's largest element from XLA's, and 172 of 1.78M
elements fall outside JAX's per-element limits; each is about as far from
the port's float64 gradients (1.4e-4 torch, 9.4e-5 XLA; 74 and 8 elements
outside those limits). A wrong cotangent hop or a lost payload moves
gradients by their own size.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from tests._torch_port_common import few_threads, jax_random_model, small_flagship_cfg  # noqa: F401
from tests._torch_parallel_ranks import flat
from yolosomi_tpu.losses import ComputeLoss as JaxComputeLoss
from yolosomi_tpu.models.yolo import build_model as jax_build_model, init_model
from yolosomi_tpu.parallel import pipeline as jax_pipeline
from yolosomi_tpu.utils.config import DEFAULT_HYP, find_config, load_model_cfg
from yolosomi_tpu_torch.data.datasets import pad_targets
from yolosomi_tpu_torch.engine.optim import make_optimizer
from yolosomi_tpu_torch.engine.trainer import upload_images
from yolosomi_tpu_torch.losses import ComputeLoss
from yolosomi_tpu_torch.models.yolo import build_model
from yolosomi_tpu_torch.parallel.pipeline import PipelineTrainer, balance_stages, pipeline_infer, stage_payload_keys
from yolosomi_tpu_torch.utils.weights import export_jax_variables, export_param_tree, load_jax_variables

NC, IMGSZ, BATCH = 4, 64, 4
SPLIT = 10  # yolov5n's backbone with SPPF | neck and head
M, MB = 3, 2  # pipeline_infer's microbatches


def v5n_cfg() -> dict:
    cfg = dict(load_model_cfg(find_config("yolov5n")))
    cfg["nc"] = NC
    return cfg


def pp_batch():
    """JAX's _pp_setup batch: b4 of noise, two boxes an image."""
    rng = np.random.default_rng(3)
    images = rng.standard_normal((BATCH, IMGSZ, IMGSZ, 3)).astype(np.float32)
    labels = [np.array([[i % 4, 0.5, 0.5, 0.3, 0.25], [(i + 1) % 4, 0.3, 0.6, 0.2, 0.2]], np.float32)
              for i in range(BATCH)]
    return images, pad_targets(labels, 8)


def infer_images():
    return np.random.default_rng(11).standard_normal((M * MB, IMGSZ, IMGSZ, 3)).astype(np.float32)


def port_v5n(variables):
    model, meta = build_model(v5n_cfg(), nc=NC, device="cpu")
    unmatched, unused = load_jax_variables(model, variables)
    assert not unmatched and not unused
    return model, meta


@pytest.fixture(scope="module")
def jax_side():
    """yolov5n from init_model; JAX's 2-stage pipeline_infer on the
    infer images and value_and_grad of the whole graph on the pp batch,
    compiled on threads of their own."""
    model, meta = jax_build_model(v5n_cfg(), nc=NC)
    variables = jax.device_get(init_model(model, meta, imgsz=IMGSZ))
    loss_fn = JaxComputeLoss(meta, dict(DEFAULT_HYP))
    images, targets = pp_batch()

    def ref_loss(params):
        preds, _ = model.apply({"params": params, "batch_stats": variables["batch_stats"]}, jnp.asarray(images),
                               train=True, mutable=["batch_stats"])
        return loss_fn(preds, jnp.asarray(targets))[0]

    def infer():
        mesh = Mesh(np.asarray(jax.devices()[:2]), ("stage",))
        fn = jax_pipeline.pipeline_infer(model, variables, mesh, SPLIT, imgsz=IMGSZ, microbatch=MB)
        return jax.device_get(fn(variables, jnp.asarray(infer_images())))

    with ThreadPoolExecutor(2) as pool:
        vg = pool.submit(lambda: jax.device_get(jax.jit(jax.value_and_grad(ref_loss))(variables["params"])))
        piped = pool.submit(infer)
        (loss, grads), piped = vg.result(), piped.result()
    return dict(model=model, variables=jax.tree_util.tree_map(np.asarray, variables), loss=float(loss),
                grads=flat(grads), piped=[np.asarray(p) for p in piped], loss_fn=loss_fn)


@pytest.mark.parametrize("cfg_name", ["yolo-somi", "yolov5n"])
def test_stage_payload_keys_and_balance_match_jax(cfg_name):
    """At every boundary the payload keys, and for 1-6 stages the DP's
    boundaries, are JAX's on the same graph (the flagship at width 0.25 /
    depth 0.33, yolov5n)."""
    cfg = small_flagship_cfg() if cfg_name == "yolo-somi" else v5n_cfg()
    jmodel, _, jvars = jax_random_model(cfg, nc=NC)
    model, _ = build_model(cfg, nc=NC, device="cpu")
    n = len(model.model)
    assert n == len(jmodel.layers)
    for split in range(1, n):
        assert stage_payload_keys(model, split) == jax_pipeline.stage_payload_keys(jmodel, split), split
    for s in range(1, 7):
        assert balance_stages(model, s) == jax_pipeline.balance_stages(jmodel, jvars, s), s


def test_pipeline_infer_matches_jax_and_the_sequential_forward(jax_side):
    """yolov5n split after SPPF, 3 microbatches of 2 over 2 stages: the
    head maps equal JAX's pipeline_infer and the port's own forward."""
    model, _ = port_v5n(jax_side["variables"])
    x = upload_images(infer_images(), torch.device("cpu"))
    assert stage_payload_keys(model, SPLIT) == (4, 6)
    got = pipeline_infer(model, ["cpu", "cpu"], SPLIT, MB)(x)
    with torch.no_grad():
        want = model(x)
    assert len(got) == len(want) == len(jax_side["piped"])
    for g, w, j in zip(got, want, jax_side["piped"]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="multiple of microbatch"):
        pipeline_infer(model, ["cpu", "cpu"], SPLIT, 4)(x)


def test_pipeline_trainer_at_microbatch_batch_matches_jax_value_and_grad(jax_side):
    """3 stages, one microbatch: the loss and every stage's gradients are
    JAX's value_and_grad over the whole graph (BatchNorm in train mode),
    which proves the payload routing, the recompute and the cotangent
    hops; and the port's own one-process step, bit for bit; the BatchNorm
    statistics moved once, as that step's."""
    model, meta = port_v5n(jax_side["variables"])
    images, targets = pp_batch()
    loss_fn = ComputeLoss(meta, dict(DEFAULT_HYP))
    ref = port_v5n(jax_side["variables"])[0].train()
    trainer = PipelineTrainer(model, loss_fn, 3, devices=["cpu"] * 3, microbatch=BATCH)
    loss = trainer.step(images, targets)
    ref_loss = loss_fn(ref(upload_images(images, torch.device("cpu"))), torch.as_tensor(targets))[0]
    names, params = zip(*ref.named_parameters())
    ref_grads = flat(export_param_tree(ref, list(names), list(torch.autograd.grad(ref_loss, params))))
    np.testing.assert_allclose(loss, jax_side["loss"], rtol=1e-5)
    assert loss == ref_loss.item()
    got = {}
    for st, g in zip(trainer.stages, trainer.grads):
        got.update(flat(export_param_tree(st, list(g), list(g.values()))))
    assert set(got) == set(jax_side["grads"]) == set(ref_grads)
    for k, want in jax_side["grads"].items():
        assert np.abs(got[k] - want).max() <= 5e-4 * np.abs(want).max(), (k, np.abs(got[k] - want).max())
        np.testing.assert_array_equal(got[k], ref_grads[k], err_msg=k)
    want_stats = flat(export_jax_variables(ref)["batch_stats"])
    got_stats = {}
    for st in trainer.stages:
        got_stats.update(flat(export_jax_variables(st)["batch_stats"]))
    for k, v in want_stats.items():
        np.testing.assert_array_equal(got_stats[k], v, err_msg=k)


def test_pipeline_trainer_microbatched_training_descends(jax_side):
    """2 microbatches on 3 stages, each stage stepping its own optimizer
    state: the losses stay finite and fall over six steps."""
    model, meta = port_v5n(jax_side["variables"])
    images, targets = pp_batch()
    hyp = dict(DEFAULT_HYP, warmup_epochs=0, lr0=0.01)
    opt = make_optimizer(hyp, nb=1, epochs=10, batch_size=BATCH)
    trainer = PipelineTrainer(model, ComputeLoss(meta, hyp), 3, devices=["cpu"] * 3, optimizer=opt, microbatch=2)
    losses = [trainer.step(images, targets) for _ in range(6)]
    assert all(np.isfinite(losses)), losses
    assert losses[-1] < losses[0], losses
    assert trainer.grads is None and all(int(s.step) == 6 for s in trainer.opt_state)


def test_stages_hold_their_rows_and_merge_back_through_the_weight_bridge(jax_side):
    """4 stages: each stage's bytes are JAX's PipelineTrainer's for the same
    variables, no stage holds more than 60% of the whole, and the merged
    state_dict loads into a fresh model whose flax variables are the
    original's, bit for bit."""
    model, meta = port_v5n(jax_side["variables"])
    trainer = PipelineTrainer(model, ComputeLoss(meta, dict(DEFAULT_HYP)), 4, devices=["cpu"] * 4)
    jtrainer = jax_pipeline.PipelineTrainer(jax_side["model"], jax_side["variables"], jax_side["loss_fn"], 4,
                                            devices=jax.devices()[:4], optimizer=None)
    per = trainer.per_device_param_bytes()
    assert per == [int(b) for b in jtrainer.per_device_param_bytes()]
    assert max(per) < 0.6 * sum(per)
    assert trainer.bounds == tuple(jtrainer.bounds)
    fresh, _ = build_model(v5n_cfg(), nc=NC, device="cpu", seed=5)
    fresh.load_state_dict(trainer.merged_state_dict())
    want = export_jax_variables(model)
    got = export_jax_variables(fresh)
    for c in ("params", "batch_stats"):
        for k, v in flat(want[c]).items():
            np.testing.assert_array_equal(flat(got[c])[k], v, err_msg=k)
