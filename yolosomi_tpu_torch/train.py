"""Training (counterpart of the root train.py of the JAX package, :56-717).

    python -m yolosomi_tpu_torch.train --data <data yaml> --cfg yolo-somi --hyp hyp.visdrone \
        [--epochs 300 --batch-size 16 --imgsz 640] [--device cpu] [--no-bf16]

The loop: autoanchor (unless --noautoanchor), the augmenting loader
(mosaic, mixup, perspective, HSV, flips; --rect, --quad, --image-weights,
--cache ram), the train step (bf16 under autocast by default, f32 with
--no-bf16; the finite guard, --accumulate, --freeze, --multi-scale,
--remat, --rep, --device-preprocess, and --cache device, whose mosaic is
composited on the device), the DFL heads' task-aligned loss
(losses_v8.py; Segment and RT-DETR have no loss and refuse), distillation
from a frozen teacher (--teacher, --teacher-cfg, --distill,
--distill-hint; engine/distill.py), validation of the EMA weights every
epoch with the val losses, results.csv, and weights/last.ckpt and best.ckpt (the JAX package's
checkpoint layout, written on a background thread) stripped at the end
to last.msgpack and best.msgpack. --resume continues a run from its
last.ckpt: weights, BatchNorm statistics, EMA, optimizer state and epoch.
--weights starts from another run's parameters wherever path and shape
match. --evolve N runs N generations of the hyperparameter search
(engine/evolve.py), each a training run named <name>_gen<i>, logged to
<project>/evolve/evolve.csv; it returns the best fitness.

Runs on CUDA unless --device names another device. Data parallelism over
N GPUs (the JAX CLI's mesh over every chip):

    torchrun --standalone --nproc_per_node N -m yolosomi_tpu_torch.train ... --batch-size <global batch>

--batch-size is the global batch, as in JAX; it must divide by N (by 4N
under --quad). Each rank loads its slice of every global batch and the
step is the one-process step on the global batch (parallel/mesh.py,
engine/trainer.py): BatchNorm statistics are the global batch's, so
--sync-bn changes nothing, as in JAX. Autoanchor runs on rank 0 and its
anchors are broadcast; the multi-scale size comes from a generator seeded
alike on every rank from (seed, epoch, batch); validation, results.csv,
train_log.jsonl, the checkpoints and --evolve's mutation happen on rank 0,
whose results every rank receives. Options of the JAX
CLI that are not ported raise NotImplementedError naming their ROADMAP
item. The DCN variant trains on CUDA through the sampling kernels' own
gradient kernels (ops/dcn.py). Besides the JAX package's files, each run writes
train_log.jsonl: one JSON object per epoch with its losses, metrics,
host-clock timings and the launches of the hand-written kernels (this
rank's train steps and, on rank 0, the val forwards).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import random
import time
from pathlib import Path

import numpy as np
import torch
import yaml

from yolosomi_tpu_torch import val as validate
from yolosomi_tpu_torch.data.datasets import DataLoader, DetectionDataset
from yolosomi_tpu_torch.engine.checkpoint import (AsyncCheckpointer, load_artifact, load_checkpoint,
                                                  restore_train_state, strip_checkpoint)
from yolosomi_tpu_torch.engine.distill import plant_adapters, wrap_loss_with_distillation
from yolosomi_tpu_torch.engine.ema import EarlyStopping
from yolosomi_tpu_torch.engine.evolve import log_generation, mutate
from yolosomi_tpu_torch.engine.optim import current_lr, make_optimizer
from yolosomi_tpu_torch.engine.runner import V8_HEADS, Runner
from yolosomi_tpu_torch.engine.trainer import create_train_state, make_train_step
from yolosomi_tpu_torch.losses import ComputeLoss
from yolosomi_tpu_torch.losses_v8 import ComputeLossV8
from yolosomi_tpu_torch.models.yolo import build_model, parse_model
from yolosomi_tpu_torch.utils.autoanchor import check_anchors
from yolosomi_tpu_torch.utils.callbacks import Callbacks
from yolosomi_tpu_torch.utils.config import find_config, load_data_cfg, load_hyp, load_model_cfg, save_yaml
from yolosomi_tpu_torch.ops import dcn as dcn_ops, odconv as odconv_ops
from yolosomi_tpu_torch.ops.mosaic_device import build_device_cache
from yolosomi_tpu_torch.parallel import mesh
from yolosomi_tpu_torch.utils.general import (LOGGER, check_img_size, get_latest_run, increment_path,
                                              labels_to_class_weights, labels_to_image_weights, log_rank,
                                              resolve_device)
from yolosomi_tpu_torch.utils.loggers import ResultsCSV
from yolosomi_tpu_torch.utils.metrics import fitness
from yolosomi_tpu_torch.utils.weights import load_jax_variables, load_matching_params, without_adapters

# options of the JAX CLI this port does not have yet: (attribute, when it is on, what and its ROADMAP item)
NOT_PORTED = (
    ("upload_dataset", lambda v: v, "--upload-dataset (Weights & Biases) is not ported"),
)
MULTI_SCALE = (0.67, 0.83, 1.0, 1.17, 1.33)  # --multi-scale's factors of imgsz
# the hand-written kernels a train step or a val forward may launch; each wrapper counts its launches
TRAIN_KERNELS = ((odconv_ops, ("odconv_s2", "odconv_s2_dx", "odconv_s2_dwmix")),
                 (dcn_ops, ("dcnv2_im2col", "dcnv3_core", "dcnv2_im2col_bwd", "dcnv3_core_bwd")))
# heads the JAX package ships no loss for (its ComputeLoss takes neither Segment's (levels, proto) nor RT-DETR's rows)
NO_LOSS = ("Segment", "RTDETRDecoder")


def _refuse_unported(opt) -> None:
    defaults = vars(parse_opt([]))
    for attr, on, what in NOT_PORTED:
        if on(getattr(opt, attr, defaults[attr])):
            raise NotImplementedError(what)


def _cache_mode(opt, hyp: dict) -> str:
    """'', 'ram' or 'device'; 'device' with a blocker on warns and loads on
    the host, as the JAX CLI does."""
    mode = "ram" if opt.cache is True else (opt.cache or "")  # an older opt.yaml stored a bool
    if mode not in ("", "ram", "device"):
        raise ValueError(f"--cache {mode!r}: expected 'ram' or 'device'")
    if mode == "device":  # its composite draws square mosaics and letterboxes from one slab
        blockers = [k for k, on in (("rect", opt.rect), ("quad", opt.quad),
                                    ("copy_paste", hyp.get("copy_paste", 0.0) > 0)) if on]
        if blockers:
            LOGGER.warning(f"--cache device does not support {blockers}; using host pipeline")
            return ""
    return mode


def _teacher(opt, meta, nc: int, device, amp_dtype):
    """--teacher: the frozen teacher (its file's weights and anchors,
    --teacher-cfg's graph or the student's; eval mode, no gradients,
    float32 weights run under the student's autocast), its meta, and the
    level map: student level i learns from the teacher level of the same
    stride, so a P3-P5 student distills from the P2-P5 flagship
    (JAX train.py:235-271)."""
    if meta.head_type in V8_HEADS:  # their DFL soft targets, in the JAX package either
        raise SystemExit("--teacher: distillation supports anchor-based heads only "
                         "(anchor-free DFL soft targets not implemented)")
    t_vars, t_anchors = load_artifact(opt.teacher)
    t_cfg = opt.teacher_cfg or opt.cfg
    teacher, t_meta = build_model(load_model_cfg(find_config(t_cfg)), nc=nc, device=device, seed=opt.seed,
                                  anchors=t_anchors.reshape(len(t_anchors), -1).tolist() if t_anchors is not None
                                  else None, compute_dtype=amp_dtype)
    unmatched, unused = load_jax_variables(teacher, t_vars)
    unused = without_adapters(unused)  # a hint-distilled student as the teacher
    if unmatched or unused:
        raise ValueError(f"--teacher {opt.teacher} does not fit {t_cfg}: unmatched {unmatched[:5]}, "
                         f"unused {unused[:5]}")
    teacher.requires_grad_(False)
    t_strides = [int(s) for s in t_meta.strides]
    try:
        level_map = tuple(t_strides.index(int(s)) for s in meta.strides)
    except ValueError:
        raise SystemExit(f"--teacher: student strides {[int(s) for s in meta.strides]} are not a subset of teacher "
                         f"strides {t_strides} — no level mapping exists")
    if t_meta.anchors_px.shape[1] != meta.anchors_px.shape[1]:
        raise SystemExit(f"--teacher: anchors-per-level differ between teacher ({t_meta.anchors_px.shape[1]}) and "
                         f"student ({meta.anchors_px.shape[1]}) — soft targets are per-anchor")
    if level_map != tuple(range(meta.nl)):
        LOGGER.info(f"distillation: level map student->teacher = {list(level_map)} (teacher strides {t_strides})")
    return teacher, t_meta, level_map


def _launches() -> dict:
    return {name: getattr(mod, name).launches for mod, names in TRAIN_KERNELS for name in names}


def _mean_losses(logged: list) -> np.ndarray:
    return np.mean(logged, 0) if logged else np.zeros(3)


def train(hyp: dict, opt, callbacks: Callbacks = None) -> float:
    """One training run; returns the best fitness. Under a process group
    (torchrun, or parallel.mesh.spawn_local) one rank of a data-parallel
    run (the module docstring)."""
    _refuse_unported(opt)
    cache_mode = _cache_mode(opt, hyp)
    group = mesh.init_data_parallel()
    rank, world = (group.rank, group.world) if group is not None else (0, 1)
    main_rank = rank == 0
    log_rank(rank)
    if opt.batch_size % (world * (4 if opt.quad else 1)):
        raise ValueError(f"--batch-size {opt.batch_size} (the global batch) must divide by {world} ranks"
                         + (" times 4 under --quad" if opt.quad else ""))
    callbacks = (callbacks or Callbacks()) if main_rank else Callbacks()
    # the loader's host draws: a rank's own stream, except that plans (--cache device) are drawn alike on every rank
    host_seed = opt.seed + (rank if cache_mode != "device" else 0)
    random.seed(host_seed)
    np.random.seed(host_seed)
    device = resolve_device(opt.device or None)
    save_dir = increment_path(Path(opt.project) / opt.name, exist_ok=opt.exist_ok, mkdir=main_rank)
    if group is not None:
        save_dir = mesh.broadcast_object(save_dir, group)
    last, best = save_dir / "weights" / "last.ckpt", save_dir / "weights" / "best.ckpt"
    if main_rank:
        (save_dir / "weights").mkdir(parents=True, exist_ok=True)
        save_yaml(save_dir / "hyp.yaml", hyp)
        save_yaml(save_dir / "opt.yaml", vars(opt))
    callbacks.run("on_pretrain_routine_start")

    data_dict = load_data_cfg(find_config(opt.data, "data"))
    nc = 1 if opt.single_cls else int(data_dict["nc"])
    names = data_dict.get("names", [str(i) for i in range(nc)])
    cfg = load_model_cfg(find_config(opt.cfg))
    amp_dtype = None if opt.no_bf16 else torch.bfloat16
    with torch.device("meta"):  # the graph's geometry; nothing is allocated
        meta = parse_model(dict(cfg, nc=nc))[1]
    if meta.head_type in NO_LOSS:
        raise NotImplementedError(f"the {meta.head_type} head has no training loss, in the JAX package either: it "
                                  "serves (val, detect) but does not train")
    gs = int(max(meta.strides))
    imgsz = check_img_size(opt.imgsz, s=gs)

    # loss gains scaled to the number of levels, classes and image size
    hyp = dict(hyp)
    hyp["box"] *= 3.0 / meta.nl
    hyp["cls"] *= nc / 80.0 * 3.0 / meta.nl
    hyp["obj"] *= (imgsz / 640) ** 2 * 3.0 / meta.nl

    device_cache = cache_mode == "device"
    if device_cache:  # the mosaic, the warp and mixup on the device, then HSV and flips in the step
        opt.device_preprocess = True
        LOGGER.info("--cache device: the Albumentations plane (Blur/MedianBlur/ToGray/CLAHE) runs on the host only "
                    "and is inactive in this mode")
    ds_hyp = dict(hyp)
    if opt.device_preprocess:  # HSV and flips move into the train step: not twice
        for k in ("hsv_h", "hsv_s", "hsv_v", "fliplr", "flipud"):
            ds_hyp[k] = 0.0
    train_ds = DetectionDataset(data_dict["train"], img_size=imgsz, augment=True, hyp=ds_hyp, rect=opt.rect,
                                max_labels=opt.max_labels, batch_size=opt.batch_size, stride=gs,
                                cache_images=cache_mode == "ram")
    train_loader = DataLoader(train_ds, opt.batch_size, shuffle=not opt.rect, drop_last=True, workers=opt.workers,
                              quad=opt.quad, plan=device_cache, rank=rank, world=world)
    if opt.sync_bn:
        LOGGER.info("--sync-bn: BN statistics are always global-batch under the data-parallel step "
                    "(SyncBN by construction)")
    nb = len(train_loader)
    if nb == 0:
        raise ValueError(f"{len(train_ds)} training images make no batch of {opt.batch_size}")

    ckpt = load_checkpoint(opt.weights) if opt.weights and Path(opt.weights).exists() else None
    anchors = None
    if opt.resume and ckpt is not None and ckpt.get("anchors") is not None:
        anchors = np.asarray(ckpt["anchors"], np.float32).reshape(meta.nl, -1).tolist()  # the run's own
    elif not opt.noautoanchor:
        if main_rank:
            new = check_anchors(train_ds, meta, thr=hyp["anchor_t"], imgsz=imgsz, kmean=opt.kmean)
            anchors = new.tolist() if new is not None else None
        if group is not None:
            anchors = mesh.broadcast_object(anchors, group)
    if group is not None and device_cache:  # rank 0's autoanchor drew from numpy: the plans' streams restart alike
        random.setstate(mesh.broadcast_object(random.getstate(), group))
        np.random.set_state(mesh.broadcast_object(np.random.get_state(), group))
    model, meta = build_model(cfg, nc=nc, device=device, dtype=torch.float32, seed=opt.seed, anchors=anchors,
                              compute_dtype=amp_dtype, imgsz=min(imgsz, 256))  # MHSA's size, as JAX's init_model
    meta.names = names
    anchors_out = np.asarray(meta.anchors_px, np.float32).reshape(meta.nl, -1)
    teacher, hint = None, float(opt.distill_hint or 0.0)
    if opt.teacher:
        teacher, t_meta, level_map = _teacher(opt, meta, nc, device, amp_dtype)
        if hint > 0:  # the FitNets adapters, before the checkpoint, the optimizer and the EMA see the model
            shapes = plant_adapters(model, meta, t_meta, level_map, opt.seed)
            LOGGER.info(f"distillation: hint={hint} adapters {shapes}")

    start_epoch, best_fitness = 0, 0.0
    if ckpt is not None:
        loaded, total = load_matching_params(model, ckpt["params"])
        LOGGER.info(f"transferred {loaded}/{total} params from {opt.weights}")
        if opt.resume:
            start_epoch = int(ckpt.get("epoch", -1)) + 1
            best_fitness = float(ckpt.get("best_fitness", 0.0))
    if group is not None:  # the same weights on every rank (replicate_tree)
        mesh.replicate_(model)
        if teacher is not None:
            mesh.replicate_(teacher)

    accumulate = max(round(64 / opt.batch_size), 1) if opt.accumulate else 1
    optimizer = make_optimizer(hyp, nb=max(nb // accumulate, 1), epochs=opt.epochs, batch_size=opt.batch_size,
                               accumulate=accumulate, adam=opt.adam, linear_lr=opt.linear_lr)
    state = create_train_state(model, optimizer, accumulate=accumulate)
    if start_epoch > 0:
        if restore_train_state(state, ckpt, fresh=("kd_adapter_",) if hint > 0 else ()):
            LOGGER.warning("--distill-hint with --resume: the checkpoint has no adapters; they start from their "
                           "seed draw and their optimizer state from zero")
        state.step = start_epoch * nb
        LOGGER.info(f"resuming at epoch {start_epoch}, optimizer step {int(state.opt_state.step)}")
    if meta.head_type in V8_HEADS:  # the task-aligned assigner's loss (train.py:226-230)
        loss_fn = ComputeLossV8(meta, hyp)
    else:
        loss_fn = ComputeLoss(meta, hyp)
        loss_fn.rep = opt.rep
    if teacher is not None:
        amp = (lambda: torch.autocast(device.type, dtype=amp_dtype)) if amp_dtype else contextlib.nullcontext

        def teacher_apply(t, images):  # at the step's own input (its multi-scale size), outside any remat
            with torch.no_grad(), amp():
                return t(images, features=hint > 0)

        loss_fn = wrap_loss_with_distillation(loss_fn, teacher_apply, meta, alpha=opt.distill,
                                              teacher_anchors_px=t_meta.anchors_px[list(level_map)],
                                              level_map=level_map, hint=hint)
        LOGGER.info(f"distillation: teacher={opt.teacher} alpha={opt.distill}")
    # one step per size; multi-scale picks one per batch with Python's random, as the JAX loop does
    sizes = sorted({max(int(imgsz * f) // gs * gs, gs) for f in MULTI_SCALE}) if opt.multi_scale else [imgsz]
    train_steps = {s: make_train_step(loss_fn, optimizer, accumulate=accumulate, freeze=opt.freeze,
                                      amp_dtype=amp_dtype, scale_to=s if opt.multi_scale else None,
                                      device_preprocess=dict(hyp, seed=opt.seed) if opt.device_preprocess else None,
                                      device_mosaic=imgsz if device_cache else None, remat_segments=opt.remat,
                                      group=group)
                   for s in sizes}
    if opt.multi_scale:
        LOGGER.info(f"multi-scale sizes: {sizes}")
    slab = None
    if device_cache:
        slab = torch.from_numpy(build_device_cache(train_ds)[0]).to(device)
        LOGGER.info(f"--cache device: {slab.numel() / 1e9:.2f} GB train slab on {device}")

    # validation on rank 0: the EMA weights, copied each epoch into a model
    # of the compute dtype, decoded with the run's anchors
    if main_rank:
        val_runner = Runner(str(find_config(opt.cfg)), nc=nc, dtype=amp_dtype or torch.float32, imgsz=imgsz,
                            device=device, seed=opt.seed)
        val_runner.meta = meta
        val_loader = DataLoader(DetectionDataset(data_dict["val"], img_size=imgsz), opt.batch_size)
        results_csv = ResultsCSV(save_dir)
        callbacks.register_action("on_fit_epoch_end", "results.csv", results_csv.log_epoch)
    stopper = EarlyStopping(patience=opt.patience)
    ckpt_writer = AsyncCheckpointer() if main_rank else None
    log_every = max(nb // 10, 1)
    LOGGER.info(f"Image sizes {imgsz} train/val, {len(train_ds)} images, {nb} batches/epoch, device {device}, "
                f"{'bf16' if amp_dtype else 'f32'}, accumulate {accumulate}"
                + (f", {world} data-parallel ranks of {opt.batch_size // world} images" if group else "")
                + f". Starting training for {opt.epochs} epochs...")
    callbacks.run("on_pretrain_routine_end")
    callbacks.run("on_train_start")

    t0 = time.time()
    final_epoch = start_epoch
    prev_best = best_fitness
    maps = np.zeros(nc)  # per-class mAP of the last validation, for --image-weights
    try:
        for epoch in range(start_epoch, opt.epochs):
            final_epoch = epoch
            callbacks.run("on_train_epoch_start")
            t_ep = time.perf_counter()
            launched = _launches()
            if opt.image_weights:  # sampling weighted to the classes the model finds hard
                cw = labels_to_class_weights(train_ds.labels, nc) * (1 - maps) ** 2 / nc
                train_loader.sample_weights = labels_to_image_weights(train_ds.labels, nc, cw)
            logged, losses, n_skipped = [], [], 0
            t_wait = 0.0
            pending = None  # (batch index, metrics) read after the next step is queued
            it = iter(train_loader)
            for i in range(nb):
                t_a = time.perf_counter()
                images, targets, _, _ = next(it)
                t_wait += time.perf_counter() - t_a
                # the same size on every rank: a generator seeded from (seed, epoch, batch)
                size = sizes[int(np.random.default_rng((opt.seed, epoch, i)).integers(len(sizes)))]
                step = train_steps[size]
                metrics = step(state, (slab, images) if device_cache else images, targets, aux=teacher)
                if pending is not None:
                    logged.append(_log_step(epoch, opt.epochs, nb, *pending, losses))
                    n_skipped += not logged[-1]
                pending = (i, metrics) if i % log_every == 0 or i == nb - 1 else None
                callbacks.run("on_train_batch_end", i)
            if pending is not None:
                logged.append(_log_step(epoch, opt.epochs, nb, *pending, losses))
                n_skipped += not logged[-1]
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t_train = time.perf_counter() - t_ep
            mloss = _mean_losses([m[1:] for m in losses])
            if n_skipped:
                LOGGER.warning(f"epoch {epoch}: {n_skipped}/{len(logged)} logged steps skipped on non-finite "
                               "gradients")
            callbacks.run("on_train_epoch_end", epoch)

            t_val = time.perf_counter()
            val_ran = (not opt.noval and epoch % max(opt.val_period, 1) == 0) or epoch == opt.epochs - 1
            results = (0.0,) * 7
            if val_ran and main_rank:
                val_runner.model.load_state_dict({k: v for k, v in state.ema.ema.state_dict().items()
                                                  if not k.startswith("kd_adapter_")})
                results, maps, _ = validate.run(data_dict, batch_size=opt.batch_size, imgsz=imgsz, runner=val_runner,
                                             project=str(save_dir), name="val", exist_ok=True, names=names,
                                             single_cls=opt.single_cls, compute_loss=loss_fn, dataloader=val_loader)
            if val_ran and group is not None:  # rank 0's results decide best, early stopping and image weights
                results, maps = mesh.broadcast_object((tuple(results), maps), group)
            t_val = time.perf_counter() - t_val
            fi = float(fitness(np.array(results[:4])))
            best_fitness = max(best_fitness, fi)
            callbacks.run("on_fit_epoch_end", epoch, mloss, results, fi)

            opt_step = int(state.opt_state.step)
            record = {"epoch": epoch, "steps": nb, "logged_losses": losses, "skipped_logged": n_skipped,
                      "opt_step": opt_step, "lr": current_lr(hyp, opt_step, max(nb // accumulate, 1), opt.epochs,
                                                             opt.linear_lr),
                      "loss": mloss.tolist(), "results": list(results),
                      "fitness": fi, "train_s": t_train, "loader_wait_s": t_wait, "val_s": t_val,
                      "kernel_launches": {k: v - launched[k] for k, v in _launches().items()}}
            if device.type == "cuda":
                record["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
            if main_rank:
                with open(save_dir / "train_log.jsonl", "a") as f:
                    f.write(json.dumps(record) + "\n")

            if (not opt.nosave or epoch == opt.epochs - 1) and main_rank:
                improved = fi > prev_best
                prev_best = max(prev_best, fi)
                if epoch % max(opt.ckpt_period, 1) == 0 or improved or epoch == opt.epochs - 1:
                    paths = [last] + ([best] if fi == best_fitness else [])
                    if opt.save_period > 0 and epoch % opt.save_period == 0:
                        paths.append(last.parent / f"epoch{epoch}.ckpt")
                    ckpt_writer.save(paths, state, epoch=epoch, best_fitness=best_fitness, anchors=anchors_out)
                    callbacks.run("on_model_save", paths, epoch, fi)
            LOGGER.info(f"epoch {epoch} done in {time.perf_counter() - t_ep:.1f}s (train {t_train:.1f}s, loader "
                        f"wait {t_wait:.1f}s, val {t_val:.1f}s) fitness {fi:.4f}")
            if group is not None:
                mesh.barrier(group)
            if val_ran and stopper(epoch, fi):
                LOGGER.info(f"early stopping at epoch {epoch} (patience {opt.patience})")
                if main_rank:
                    ckpt_writer.save([last], state, epoch=epoch, best_fitness=best_fitness, anchors=anchors_out)
                break
    finally:
        if ckpt_writer is not None:
            ckpt_writer.close()
    LOGGER.info(f"{final_epoch - start_epoch + 1} epochs in {(time.time() - t0) / 3600:.3f}h")
    if main_rank:
        for f in (last, best):
            if f.exists():
                strip_checkpoint(f, f.with_suffix(".msgpack"))
    callbacks.run("on_train_end", last, best, final_epoch)
    if group is not None:  # every rank returns once the run's files are written
        mesh.barrier(group)
    return best_fitness


def _log_step(epoch: int, epochs: int, nb: int, i: int, metrics: dict, losses: list) -> bool:
    """Read one step's metrics (a host sync), log them, add [i, box, obj,
    cls] to `losses`; True when the step's gradients were finite."""
    m = {k: float(v) for k, v in metrics.items()}
    ok = bool(m["grads_finite"])
    losses.append([i, m["lbox"], m["lobj"], m["lcls"]])
    LOGGER.info(f"epoch {epoch}/{epochs - 1} batch {i}/{nb} box {m['lbox']:.4f} obj {m['lobj']:.4f} "
                f"cls {m['lcls']:.4f}{'' if ok else ' SKIPPED(non-finite grads)'}")
    return ok


def parse_opt(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--weights", type=str, default="", help="initial weights (.ckpt/.msgpack)")
    parser.add_argument("--cfg", type=str, default="yolo-somi")
    parser.add_argument("--data", type=str, default="visdrone")
    parser.add_argument("--hyp", type=str, default="hyp.visdrone")
    parser.add_argument("--epochs", type=int, default=300)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--imgsz", "--img", "--img-size", type=int, default=640)
    parser.add_argument("--rect", action="store_true", help="aspect-sorted rectangular batches, no mosaic")
    parser.add_argument("--multi-scale", action="store_true",
                        help="each batch resized to one of imgsz x (0.67, 0.83, 1, 1.17, 1.33), stride multiples")
    parser.add_argument("--accumulate", action="store_true", help="gradient accumulation to nominal batch 64")
    parser.add_argument("--image-weights", action="store_true", help="class-error-weighted image sampling")
    parser.add_argument("--quad", action="store_true", help="quad collate: each 4 images -> one of twice the size")
    parser.add_argument("--resume", nargs="?", const=True, default=False)
    parser.add_argument("--evolve", type=int, nargs="?", const=300, default=0,
                        help="evolve the hyps for N generations (default 300)")
    parser.add_argument("--noval", action="store_true")
    parser.add_argument("--val-period", type=int, default=1, metavar="N",
                        help="validate every N epochs (always on the final epoch)")
    parser.add_argument("--noautoanchor", action="store_true")
    parser.add_argument("--kmean", action="store_true", help="k-means++ autoanchor")
    parser.add_argument("--adam", action="store_true")
    parser.add_argument("--linear-lr", action="store_true")
    parser.add_argument("--single-cls", action="store_true")
    parser.add_argument("--rep", action="store_true", help="add the repulsion loss")
    parser.add_argument("--device-preprocess", action="store_true",
                        help="HSV jitter and flips on the device, in the train step")
    parser.add_argument("--label-smoothing", type=float, default=0.0)
    parser.add_argument("--patience", type=int, default=100)
    parser.add_argument("--project", default="runs/train")
    parser.add_argument("--name", default="exp")
    parser.add_argument("--exist-ok", action="store_true")
    parser.add_argument("--device", type=str, default="", help="torch device: cuda (default), cuda:1 or cpu")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--max-labels", type=int, default=300)
    parser.add_argument("--no-bf16", action="store_true", help="train in f32 (default: bf16 under autocast)")
    parser.add_argument("--freeze", type=int, default=0, help="freeze the first N layers")
    parser.add_argument("--teacher", type=str, default="", help="distill from this weights file or checkpoint")
    parser.add_argument("--teacher-cfg", type=str, default="", help="the teacher's model config (default --cfg)")
    parser.add_argument("--distill", type=float, default=1.0, help="weight of the distillation term")
    parser.add_argument("--distill-hint", type=float, default=0.0,
                        help="weight of the feature hint term (FitNets adapters; 0 = off)")
    parser.add_argument("--ckpt-period", type=int, default=1,
                        help="save last/best every N epochs (and on improvements and the final epoch)")
    parser.add_argument("--save-period", type=int, default=-1, help="also save a checkpoint every N epochs")
    parser.add_argument("--nosave", action="store_true", help="only save the final checkpoint")
    parser.add_argument("--cache", type=str, nargs="?", const="ram", default="",
                        help="image cache: ram (decoded once on the host) or device (one slab on the device, "
                             "mosaic, warp and mixup composited there)")
    parser.add_argument("--workers", type=int, default=8, help="loader item threads")
    parser.add_argument("--remat", type=int, default=0, metavar="N",
                        help="recompute the forward in N checkpointed segments in the backward")
    parser.add_argument("--upload-dataset", action="store_true", help="not ported")
    parser.add_argument("--sync-bn", action="store_true",
                        help="accepted: BatchNorm statistics are always the global batch's, as in JAX")
    return parser.parse_args(argv)


def main(opt):
    """The CLI: --resume's options, --evolve's generations, or one run. Under
    torchrun it initialises the process group from the environment and
    ends it at the end."""
    owned = mesh.current_group() is None
    group = mesh.init_data_parallel()
    try:
        return _main(opt, group)
    finally:
        if group is not None and owned:
            torch.distributed.destroy_process_group()


def _main(opt, group):
    if opt.resume and not opt.weights:
        # a bare --resume: the newest run under --project, with its opt.yaml
        last = opt.resume if isinstance(opt.resume, str) else get_latest_run(opt.project)
        if not last:
            raise FileNotFoundError(f"no last.ckpt found under {opt.project} to resume")
        opt_yaml = Path(last).parents[1] / "opt.yaml"
        if opt_yaml.exists():
            for k, v in yaml.safe_load(opt_yaml.read_text()).items():
                if k not in ("resume", "weights", "exist_ok") and hasattr(opt, k):
                    setattr(opt, k, v)
        opt.weights, opt.exist_ok = str(last), True
        LOGGER.info(f"resuming from {last}")
    hyp = load_hyp(find_config(opt.hyp, "hyps"))
    if opt.label_smoothing:
        hyp["label_smoothing"] = opt.label_smoothing
    if opt.evolve:
        # the genetic search (JAX train.py:688-711): mutate, train, log the fitness, repeat
        evolve_dir = Path(opt.project) / "evolve"
        evolve_dir.mkdir(parents=True, exist_ok=True)
        evolve_csv = evolve_dir / "evolve.csv"
        opt.noval, opt.exist_ok = False, True
        base_name, best = opt.name, 0.0
        for gen in range(int(opt.evolve)):
            hyp_g = mutate(hyp, evolve_csv) if group is None or group.is_main else None
            if group is not None:  # rank 0's mutation on every rank
                hyp_g = mesh.broadcast_object(hyp_g, group)
            opt.name = f"{base_name}_gen{gen}"
            fi = train(dict(hyp_g), opt)
            if group is None or group.is_main:
                log_generation(evolve_csv, hyp_g, fi)
            best = max(best, fi)
        LOGGER.warning("plot_evolve is not ported (utils/plots.py, ROADMAP queue A item 9(b)): no evolve.png")
        LOGGER.info(f"evolution complete: best fitness {best:.4f} ({evolve_csv})")
        return best
    return train(hyp, opt)


def run(**kwargs) -> float:
    """train.py from Python: parse_opt's defaults with `kwargs` over them."""
    opt = parse_opt([])
    for k, v in kwargs.items():
        if not hasattr(opt, k):
            raise TypeError(f"unknown option {k}")
        setattr(opt, k, v)
    return main(opt)


if __name__ == "__main__":
    main(parse_opt())
