"""Rank functions of the port's data-parallel tests, run on local ranks by
yolosomi_tpu_torch.parallel.mesh.spawn_local (or in one process with no
group, as the reference). This module imports neither jax nor
tests/_torch_port_common.py (which imports jax), so a spawned rank never
loads JAX, and it runs on a machine that has only PyTorch."""

from __future__ import annotations

import numpy as np
import torch

from yolosomi_tpu_torch.engine.optim import make_optimizer
from yolosomi_tpu_torch.engine.trainer import create_train_state, make_train_step
from yolosomi_tpu_torch.losses import ComputeLoss
from yolosomi_tpu_torch.losses_v8 import ComputeLossV8
from yolosomi_tpu_torch.models.yolo import build_model
from yolosomi_tpu_torch.ops.odconv import odconv_s2, odconv_s2_dwmix, odconv_s2_dx
from yolosomi_tpu_torch.parallel.mesh import shard_batch
from yolosomi_tpu_torch.utils.weights import _leaves, export_jax_variables, load_jax_variables


KERNELS = (odconv_s2, odconv_s2_dx, odconv_s2_dwmix)  # the kernels a flagship train step launches on CUDA


def flat(tree) -> dict:
    """A flax variable tree as {"a/b/c": array}."""
    return {"/".join(p): np.asarray(v) for p, v in _leaves(tree)}


def snapshot(state) -> dict:
    """Parameters, BatchNorm statistics and the EMA of a TrainState, as
    flat flax-layout numpy copies, and its optimizer step."""
    v, e = export_jax_variables(state.model), export_jax_variables(state.ema.ema)
    return dict(params=flat(v["params"]), batch_stats=flat(v["batch_stats"]), ema=flat(e["params"]),
                opt_step=int(state.opt_state.step), ema_updates=int(state.ema.updates))


def train_steps(group, cfg: dict, nc: int, variables: dict, hyp: dict, opt_kw: dict, batches: list,
                accumulate: int = 1, device: str = "cpu", amp_dtype=None, snapshots: bool = True) -> list:
    """The port's train step from `variables` (flax layout) over `batches`
    [(images (B, H, W, 3), targets (B, M, 5))], global batches: with a
    group each rank steps on its rows of each, else one process on all of
    them. Returns per batch the metrics and (with `snapshots`) the state
    after it; without, the state after the last batch only."""
    rank, world = (group.rank, group.world) if group is not None else (0, 1)
    if device.startswith("cuda"):  # full f32, as the card tests compare
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model, meta = build_model(cfg, nc=nc, device=device)
    unmatched, unused = load_jax_variables(model, variables)
    assert not unmatched and not unused, (unmatched[:3], unused[:3])
    opt = make_optimizer(dict(hyp), accumulate=accumulate, **opt_kw)
    state = create_train_state(model, opt, accumulate=accumulate)
    step = make_train_step(ComputeLoss(meta, dict(hyp)), opt, accumulate=accumulate, amp_dtype=amp_dtype, group=group)
    out = []
    for i, (images, targets) in enumerate(batches):
        before = {k.__name__: k.launches for k in KERNELS}
        m = step(state, shard_batch(images, rank, world), shard_batch(targets, rank, world))
        rec = {"metrics": {k: float(v) for k, v in m.items()},
               "launches": {k.__name__: k.launches - before[k.__name__] for k in KERNELS
                            if k.launches != before[k.__name__]}}
        if snapshots or i == len(batches) - 1:
            rec.update(snapshot(state))
        out.append(rec)
    return out


def step_grads(group, cfg: dict, nc: int, hyp: dict, images: np.ndarray, targets: np.ndarray,
               dtype=torch.float64, v8: bool = False) -> dict:
    """One train-mode forward, ComputeLoss (ComputeLossV8 with `v8`) and
    backward of `cfg` (seed-0 weights) in `dtype`, on this rank's rows of
    the global batch inside mesh.reducing(group), its gradients summed over
    the ranks: the global batch's loss and gradients, by parameter name."""
    from yolosomi_tpu_torch.engine.trainer import upload_images
    from yolosomi_tpu_torch.parallel import mesh

    rank, world = (group.rank, group.world) if group is not None else (0, 1)
    model, meta = build_model(cfg, nc=nc, device="cpu", seed=0)
    model = model.to(dtype).train()
    x = upload_images(shard_batch(images, rank, world), torch.device("cpu")).to(dtype)
    with mesh.reducing(group):
        loss_fn = (ComputeLossV8 if v8 else ComputeLoss)(meta, dict(hyp))
        loss, _ = loss_fn(model(x), torch.as_tensor(shard_batch(targets, rank, world)))
        names, params = zip(*model.named_parameters())
        grads = list(torch.autograd.grad(loss, params))
    loss = loss.detach()
    if group is not None:
        *grads, loss = mesh.all_reduce_flat(grads + [loss])
    return dict(loss=loss.item(), grads={n: g.numpy().copy() for n, g in zip(names, grads)})


def distill_grads(group, cfg: dict, nc: int, hyp: dict, images: np.ndarray, targets: np.ndarray,
                  hint: float = 0.5, dtype=torch.float64) -> dict:
    """step_grads with the distillation loss: `cfg` as the student (seed
    0, FitNets adapters planted) and as the teacher (seed 1, its
    objectness biases raised by 4 so that it is confident where the
    soft-box and hint terms look), alpha 1 and `hint`."""
    from yolosomi_tpu_torch.engine.distill import plant_adapters, wrap_loss_with_distillation
    from yolosomi_tpu_torch.engine.trainer import upload_images
    from yolosomi_tpu_torch.parallel import mesh

    rank, world = (group.rank, group.world) if group is not None else (0, 1)
    model, meta = build_model(cfg, nc=nc, device="cpu", seed=0)
    teacher, t_meta = build_model(cfg, nc=nc, device="cpu", seed=1)
    with torch.no_grad():
        for level in teacher.model[-1].m:
            level.b3.bias.view(t_meta.na, 5)[:, 4] += 4.0
    level_map = tuple(range(meta.nl))
    plant_adapters(model, meta, t_meta, level_map, seed=0)
    model, teacher = model.to(dtype).train(), teacher.to(dtype).eval()
    loss_fn = wrap_loss_with_distillation(ComputeLoss(meta, dict(hyp)), lambda t, im: t(im, features=hint > 0),
                                          meta, alpha=1.0, teacher_anchors_px=t_meta.anchors_px[list(level_map)],
                                          level_map=level_map, hint=hint)
    x = upload_images(shard_batch(images, rank, world), torch.device("cpu")).to(dtype)
    t = torch.as_tensor(shard_batch(targets, rank, world))
    with mesh.reducing(group):
        preds, feats = model(x, features=True)
        loss, _ = loss_fn(preds, t, images=x, aux=teacher, feats=feats, params=model)
        names, params = zip(*model.named_parameters())
        grads = list(torch.autograd.grad(loss, params))
    loss = loss.detach()
    if group is not None:
        *grads, loss = mesh.all_reduce_flat(grads + [loss])
    return dict(loss=loss.item(), grads={n: g.numpy().copy() for n, g in zip(names, grads)})


def train_run(group, kwargs: dict) -> dict:
    """train.run(**kwargs) on this rank; returns its fitness and the final
    state's parameters, BatchNorm statistics and EMA."""
    from yolosomi_tpu_torch import train

    states = []
    create = train.create_train_state

    def keep(*a, **kw):
        states.append(create(*a, **kw))
        return states[-1]

    train.create_train_state = keep
    try:
        fi = train.run(**kwargs)
    finally:
        train.create_train_state = create
    return dict(fitness=fi, **snapshot(states[-1]), rank=group.rank if group is not None else 0)


def bn_global(group, x: np.ndarray, momentum: float, eps: float) -> dict:
    """A FlaxBatchNorm1d over this rank's rows of `x` inside a data-parallel
    step: its output, the gradients of sum(y * w_out) (w_out = the row
    index + 1, so each rank's loss differs) with respect to x, the scale
    and the bias, and the running statistics after it."""
    from yolosomi_tpu_torch.models.layers import FlaxBatchNorm1d
    from yolosomi_tpu_torch.parallel import mesh

    rank, world = (group.rank, group.world) if group is not None else (0, 1)
    c = x.shape[1]
    bn = FlaxBatchNorm1d(c, eps=eps, momentum=momentum).train()
    with torch.no_grad():
        bn.weight.copy_(torch.linspace(0.5, 1.5, c))
        bn.bias.copy_(torch.linspace(-0.2, 0.2, c))
    xs = torch.from_numpy(np.ascontiguousarray(shard_batch(x, rank, world))).requires_grad_(True)
    w_out = torch.arange(1, x.shape[0] + 1, dtype=torch.float32)[:, None].expand(-1, c)
    with mesh.reducing(group):
        y = bn(xs)
        loss = (y * shard_batch(w_out, rank, world)).sum()
        gx, gw, gb = torch.autograd.grad(loss, [xs, bn.weight, bn.bias])
    if group is not None:
        gw, gb = mesh.all_reduce_flat([gw, gb])
    return dict(y=y.detach().numpy(), gx=gx.numpy(), gw=gw.numpy(), gb=gb.numpy(),
                mean=bn.running_mean.numpy().copy(), var=bn.running_var.numpy().copy())


def run_calls(group, calls: list) -> list:
    """[fn(group, **kwargs) for fn, kwargs in calls]: several cases in one
    spawn of the ranks."""
    return [fn(group, **kwargs) for fn, kwargs in calls]


def fail_on(group, rank: int) -> int:
    """Raise on rank `rank`; the others return their rank."""
    if group.rank == rank:
        raise ValueError(f"rank {rank} fails on purpose")
    return group.rank


def hang(group, seconds: float) -> None:
    """Rank 1 sleeps `seconds` while the others wait for it in a collective."""
    import time

    from yolosomi_tpu_torch.parallel import mesh

    if group.rank == 1:
        time.sleep(seconds)
    mesh.barrier(group)


# ---------------------------------------------------------------------------
# spatial sharding (parallel/spatial.py)
# ---------------------------------------------------------------------------


def match_rows(got: np.ndarray, want: np.ndarray, tol) -> None:
    """Rows [values..., class]: as many in both, each row of `got` matched
    by its own row of `want` of its class, every value within `tol` (the
    same rows in any order: rounding apart may sort near-equal scores
    apart)."""
    assert len(got) == len(want) > 0, (len(got), len(want))
    free = np.ones(len(want), bool)
    for row in got:
        close = free & (want[:, -1] == row[-1]) & (np.abs(want[:, :-1] - row[:-1]) <= np.asarray(tol)).all(1)
        assert close.any(), row
        free[np.argmax(close)] = False


SPATIAL_ROWS, SPATIAL_UNIT = 28, 4  # the operator cases' map: 7 units of 4 rows (16 / 12 px over 2, 12 / 8 / 8 over 3)


def spatial_case(name: str):
    """(module in eval mode, NCHW input (2, C, 28, 20) channels_last) of one
    operator case, from seed 0: random parameters and BatchNorm
    statistics; the DCN offset heads randomised so samples cross strips;
    the SPP / SPPF input convs biased to -3, so every pooled value is a
    negative SiLU output and a zero edge row would win the max."""
    from yolosomi_tpu_torch.models import dcn as D
    from yolosomi_tpu_torch.models import layers as L

    torch.manual_seed(0)
    c = 16
    make = {
        "conv3_s1": lambda: L.Conv(c, c, 3, 1),
        "conv3_s2": lambda: L.Conv(c, c, 3, 2),
        "conv6_s2_p2": lambda: L.Conv(c, c, 6, 2, 2),
        "conv3x1": lambda: L.Conv(c, c, (3, 1), 1),
        "focus": lambda: L.Focus(c, c, 3),
        "contract": lambda: L.Contract(2),
        "sppf_negative": lambda: L.SPPF(c, c, 5),
        "spp_negative": lambda: L.SPP(c, c, (5, 9, 13)),
        "cbam": lambda: L.CBAM(c, 4, 7),
        "seam": lambda: L.SEAM(c, 1, 4),
        "ema_cbam": lambda: L.EMACBAMBottleneck(c, c),
        "odconv": lambda: L.ODConv(c, 2 * c, 3, 2),
        "dcnv2": lambda: D.DCNv2(c, c, 3, 1),
        "dcnv3": lambda: D.DCNv3(c, 3, 1, 1, 1, 4),
        "maxpool_k2s2": lambda: L.MaxPool2d(2, 2, 0),
        "maxpool_k3s2p1": lambda: L.MaxPool2d(3, 2, 1),
        "zeropad_maxpool": lambda: torch.nn.Sequential(L.ZeroPad2d((0, 1, 0, 1)), L.MaxPool2d(2, 1, 0)),
        "ghost_s2": lambda: L.GhostBottleneck(c, 2 * c, 3, 2),
        "c3ghost": lambda: L.C3Ghost(c, c, 1),
        "c3tr": lambda: L.C3TR(c, c, 1),
        "scdown": lambda: L.SCDown(c, 2 * c, 3, 2),
        "c2fcib_lk": lambda: L.C2fCIB(c, c, 1, True, lk=True),
        "psa": lambda: L.PSA(c, c),
        "classify": lambda: L.Classify(c, 5),
    }[name]
    module = make()
    g = torch.Generator().manual_seed(1)
    norms = (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d, torch.nn.GroupNorm, torch.nn.LayerNorm)
    with torch.no_grad():
        for m in module.modules():
            for pname, p in list(m.named_parameters(recurse=False)) + list(m.named_buffers(recurse=False)):
                if not p.is_floating_point():
                    continue
                r = torch.randn(p.shape, generator=g)
                if pname == "running_var":
                    p.copy_(0.5 + r.abs())
                elif isinstance(m, norms) and pname == "weight":
                    p.copy_(1.0 + 0.1 * r)
                elif p.dim() > 1:  # fan in: a conv's (Cin, kh, kw), ODConv's bank per candidate and output
                    p.copy_(r * 0.5 / (p[0].numel() if p.dim() < 5 else p[0, 0].numel()) ** 0.5)
                else:
                    p.copy_(0.1 * r)
        if name.endswith("_negative"):
            module.cv1.bn.bias.fill_(-3.0)
    D.randomize_offset_heads(module, seed=0)
    module.eval()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, c, SPATIAL_ROWS, 20)).astype(np.float32))
    return module, x.contiguous(memory_format=torch.channels_last)


def spatial_operators(group, names: list) -> dict:
    """Each case of `names` on this rank's strip of SPATIAL_ROWS rows split
    over the group's ranks (one batch slice, unit SPATIAL_UNIT), under
    spatial(); its whole output map gathered back along H."""
    from yolosomi_tpu_torch.parallel.spatial import Strip, gather_h, spatial, strip_plan

    out = {}
    for name in names:
        module, x = spatial_case(name)
        strip = Strip(strip_plan(SPATIAL_ROWS, group.world, SPATIAL_UNIT), group.rank, 0, 1)
        with torch.no_grad(), spatial(strip):
            y = module(x[:, :, strip.rows])
            out[name] = (gather_h(y) if y.dim() == 4 else y).numpy()  # a Classify's logits are whole already
    return out


def spatial_runner(group, cfg: str, images: np.ndarray, shards: int, conf: float, weights: str = None,
                   device: str = "cpu", augment: bool = False) -> dict:
    """Runner(cfg, weights, f32, `device`, spatial_shards=shards) on the
    global batch `images` (every rank is handed all of it): its head maps,
    its (B, 300, 6) rows at `conf` (with TTA where `augment`), what it
    all-reduced and its kernel launches."""
    from yolosomi_tpu_torch.engine.runner import Runner
    from yolosomi_tpu_torch.ops.dcn import dcnv2_im2col, dcnv3_core
    from yolosomi_tpu_torch.ops.odconv import odconv_s2

    if device.startswith("cuda"):  # full f32, as the card tests compare
        torch.backends.cudnn.allow_tf32 = False
    r = Runner(cfg, weights, dtype=torch.float32, device=device, spatial_shards=shards)
    kernels = (odconv_s2, dcnv2_im2col, dcnv3_core)
    before = [k.launches for k in kernels]
    preds = [p.cpu().numpy() for p in r.forward(images)]
    launches = {k.__name__: k.launches - n for k, n in zip(kernels, before)}
    return dict(preds=preds, out=r(images, conf_thres=conf, augment=augment), exchange=dict(r.exchange),
                strip=r.spatial.index, launches=launches)


def spatial_entry_points(group, cfg: str, weights: list, data: dict, source: str, project: str, conf: float) -> dict:
    """attempt_load with two weights and spatial_shards=2 (an unsharded
    ensemble), val.run and detect.run with shard_spatial=2 on this rank,
    both in f32 (detect's Runner through an f32 attempt_load)."""
    import functools

    from yolosomi_tpu_torch import detect, val
    from yolosomi_tpu_torch.engine.runner import EnsembleRunner, attempt_load

    detect.attempt_load = functools.partial(attempt_load, dtype=torch.float32)

    ens = attempt_load(weights, cfg, dtype=torch.float32, device="cpu", spatial_shards=2)
    (res, maps, _) = val.run(data, weights=weights[0], cfg=cfg, batch_size=2, imgsz=256, half=False, device="cpu",
                             project=project, name="val", exist_ok=True, shard_spatial=2, save_txt=True)
    run_dir = detect.run(weights=weights[0], cfg=cfg, source=source, imgsz=256, conf_thres=conf, save_txt=True,
                         save_conf=True, project=project, name="detect", exist_ok=True, shard_spatial=2, device="cpu")
    return dict(ensemble=type(ens) is EnsembleRunner, results=list(res), maps=maps, run_dir=str(run_dir))


def spatial_refusals(group, cfg: str, weights: str, cases: list) -> list:
    """For each (shards, (batch, size)) of `cases`: the message of the
    ValueError that Runner(spatial_shards=shards) and its forward on that
    batch raise, or None."""
    from yolosomi_tpu_torch.engine.runner import Runner

    msgs = []
    for shards, (n, size) in cases:
        try:
            Runner(cfg, weights, dtype=torch.float32, device="cpu", spatial_shards=shards).forward(
                np.zeros((n, size, size, 3), np.uint8))
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    return msgs
