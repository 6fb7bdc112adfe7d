"""Training the DCN variant: the port's make_train_step against the JAX
package's (yolosomi_tpu/engine/trainer.py:80), on the CPU, for
yolo-somi-dcn at width 0.25 / depth 0.33, 64 px, batch 2, nc 10, f32, from
one set of weights and one batch sequence: once with the offset/mask heads
at their zero init (every sampling point an integer), once with them
random (fractional points, some off the map). The port's step runs DCNv2
and DCNv3 through their autograd Functions, whose backward on the CPU is
the plain version; the JAX package's through XLA's VJP of its gathers.

Each package takes three steps on its own. Then the port takes each of
the three steps again from the JAX package's state before it (weights,
BatchNorm statistics, EMA and optimizer state through a JAX checkpoint).
From the zero init, three steps on their own cannot agree leaf by leaf:
after two steps some DCNv3 offsets are ~1e-7 px, within an ulp of the
integer points where the sampling's derivative jumps, and the two
packages' trajectories, equal to ~1e-8 relative, round some of them to
opposite sides (from one state the gradients agree to 4e-8 of the
largest). So the zero-init run holds the three losses of its own steps and
every step from the JAX state; the random run holds both in full.

One JAX program, the train step, compiled once for the module and run on
both sets of weights. Tolerances are those of
tests/test_torch_port_train.py: losses 1e-5 relative; each parameter
leaf's update within 2% of its largest update plus 4 ulp of its largest
parameter; BatchNorm statistics 1e-5 relative plus 1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests._torch_port_common import _to_dict, few_threads, random_variables  # noqa: F401
from tests.test_torch_port_dcn import small_dcn_cfg
from tests.test_torch_port_train import (B, EPOCHS, NB, assert_stats_close, assert_updates_close, batches, flat,
                                         targets_batch)
from yolosomi_tpu import losses as jax_losses
from yolosomi_tpu.engine import checkpoint as jax_ckpt
from yolosomi_tpu.engine import optim as jax_optim
from yolosomi_tpu.engine import trainer as jax_trainer
from yolosomi_tpu.models.yolo import build_model as jax_build_model
from yolosomi_tpu_torch import losses
from yolosomi_tpu_torch.engine import checkpoint, optim
from yolosomi_tpu_torch.engine.trainer import create_train_state, make_train_step
from yolosomi_tpu_torch.models.yolo import build_model
from yolosomi_tpu_torch.ops import dcn as ops_dcn
from yolosomi_tpu_torch.utils.config import find_config, load_hyp
from yolosomi_tpu_torch.utils.weights import export_jax_variables, load_jax_variables

NC, IMGSZ = 10, 64
HEADS = ("conv_offset_mask", "offset", "mask")  # DCNv2's and DCNv3's offset/mask layers
VARIANTS = ("zero_heads", "random_heads")


def with_zero_heads(params: dict) -> dict:
    """The parameters with every offset/mask head zero, as the JAX init has it."""
    def walk(tree, parent):
        return {k: walk(v, k) if isinstance(v, dict) else (np.zeros_like(v) if parent in HEADS else v)
                for k, v in tree.items()}
    return walk(params, "")


def port_step(cfg, variables, hyp):
    """A port model from `variables`, its train state and train step."""
    model, meta = build_model(cfg, nc=NC, device="cpu")
    assert load_jax_variables(model, variables) == ([], [])
    opt = optim.make_optimizer(hyp, nb=NB, epochs=EPOCHS, batch_size=B)
    return model, create_train_state(model, opt), make_train_step(losses.ComputeLoss(meta, hyp), opt)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For each variant: the JAX package's three steps (metrics and the
    state after each, as arrays), the port's three steps on its own
    (metrics, the variables after them), and the port's step from each JAX
    state (metrics, the variables after it)."""
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    cfg = small_dcn_cfg()
    model, meta = jax_build_model(cfg, nc=NC)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False))
    random = _to_dict(random_variables(shapes, 1))
    variants = {"zero_heads": dict(random, params=with_zero_heads(random["params"])), "random_heads": random}
    t, imgs = targets_batch(), batches()
    opt = jax_optim.make_optimizer(hyp, nb=NB, epochs=EPOCHS, batch_size=B)
    state0 = jax_trainer.create_train_state(jax.tree_util.tree_map(jnp.asarray, random), opt)
    step = jax_trainer.make_train_step(model, jax_losses.ComputeLoss(meta, hyp), opt).lower(
        state0, jnp.asarray(imgs[0]), jnp.asarray(t)).compile({"xla_backend_optimization_level": 0})
    anchors = meta.anchors_px.reshape(meta.nl, -1)
    out = {}
    for name, variables in variants.items():
        state = jax_trainer.create_train_state(jax.tree_util.tree_map(jnp.asarray, variables), opt)
        ckpts, jmetrics, jstates = [], [], []
        for i in range(3):
            ckpts.append(tmp_path_factory.mktemp(name) / f"step{i}.ckpt")
            jax_ckpt.save_checkpoint(ckpts[-1], state, epoch=0, best_fitness=0.0, anchors=anchors)
            state, m = step(state, jnp.asarray(imgs[i]), jnp.asarray(t))
            jmetrics.append(jax.device_get(m))
            host = jax.device_get(state)
            jstates.append(dict(params=flat(host.params), stats=flat(host.batch_stats), opt_step=int(host.opt_state.step)))
        pmodel, pstate, pstep = port_step(cfg, variables, hyp)
        bwd = (ops_dcn.dcnv2_im2col_bwd.launches, ops_dcn.dcnv3_core_bwd.launches)
        pmetrics = [{k: v.item() for k, v in pstep(pstate, imgs[i], t).items()} for i in range(3)]
        assert (ops_dcn.dcnv2_im2col_bwd.launches, ops_dcn.dcnv3_core_bwd.launches) == bwd  # the CPU counts none
        forced = []
        for i in range(3):  # one port step from the JAX state before step i
            fmodel, fstate, fstep = port_step(cfg, variables, hyp)
            checkpoint.restore_train_state(fstate, checkpoint.load_checkpoint(ckpts[i]))
            assert int(fstate.opt_state.step) == i
            m = {k: v.item() for k, v in fstep(fstate, imgs[i], t).items()}
            forced.append(dict(metrics=m, after=export_jax_variables(fmodel)))
        out[name] = dict(variables=variables, jmetrics=jmetrics, jstates=jstates, pmetrics=pmetrics,
                         pstep=int(pstate.opt_state.step), after=export_jax_variables(pmodel), forced=forced)
    return out


def assert_metrics_close(got: dict, want) -> None:
    for k in ("loss", "lbox", "lobj", "lcls"):
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
    assert got["grads_finite"] and bool(want["grads_finite"])


@pytest.mark.parametrize("variant", VARIANTS)
def test_three_dcn_train_steps_match_make_train_step(runs, variant):
    """Each package's three steps on its own: the loss components of every
    step; for the random heads, the parameter updates and BatchNorm
    statistics after three steps (the zero init: the module docstring)."""
    r = runs[variant]
    for got, want in zip(r["pmetrics"], r["jmetrics"]):
        assert_metrics_close(got, want)
    assert r["pstep"] == r["jstates"][-1]["opt_step"] == 3
    if variant == "random_heads":
        assert_updates_close(flat(r["variables"]["params"]), flat(r["after"]["params"]), r["jstates"][-1]["params"])
        assert_stats_close(flat(r["after"]["batch_stats"]), r["jstates"][-1]["stats"])


@pytest.mark.parametrize("i", range(3))
@pytest.mark.parametrize("variant", VARIANTS)
def test_each_dcn_train_step_from_the_jax_state_matches(runs, variant, i):
    """Step i of the port from the JAX package's state before it: loss
    components, parameter updates and BatchNorm statistics against the
    JAX step from the same state."""
    r = runs[variant]
    before = flat(r["variables"]["params"]) if i == 0 else r["jstates"][i - 1]["params"]
    forced = r["forced"][i]
    assert_metrics_close(forced["metrics"], r["jmetrics"][i])
    assert_updates_close(before, flat(forced["after"]["params"]), r["jstates"][i]["params"])
    assert_stats_close(flat(forced["after"]["batch_stats"]), r["jstates"][i]["stats"])


@pytest.mark.parametrize("variant", VARIANTS)
def test_offset_heads_leave_their_init_in_both_packages(runs, variant):
    """Every DCNv2 and DCNv3 offset/mask head (rows 6, 8 and 10: five heads
    at depth 0.33) moves in three steps, in both packages. From the zero
    init that needs the one-sided derivative at integer points: with
    torch's abs the port's offset heads got no gradient and stayed 0."""
    r = runs[variant]
    before = flat(r["variables"]["params"])
    got, want = flat(r["after"]["params"]), r["jstates"][-1]["params"]
    heads = sorted({k.rsplit("/", 1)[0] for k in before if k.split("/")[-2] in HEADS})
    assert len([h for h in heads if h.endswith("conv_offset_mask")]) == 3
    assert len([h for h in heads if h.endswith(("/offset", "/mask"))]) == 2
    for head in heads:
        for params in (got, want):
            moved = max(np.abs(params[f"{head}/{leaf}"] - before[f"{head}/{leaf}"]).max() for leaf in ("kernel", "bias"))
            assert moved > 0, (variant, head)
    if variant == "zero_heads":  # the offsets themselves leave zero: DCNv2's dy, dx channels, DCNv3's offset head
        for head in heads:
            if head.endswith(("conv_offset_mask", "/offset")):
                for params in (got, want):
                    bias = params[f"{head}/bias"]
                    assert np.abs(bias[:18] if head.endswith("conv_offset_mask") else bias).max() > 0, head
