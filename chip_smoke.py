"""Drive the PyTorch/CUDA port (yolosomi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:
 1. device: needs CUDA; prints the card's name and power limit; TF32 off
 2. build: compiles every CUDA source of the serving, training and int8
    paths from csrc/, one nvcc per source, all started together; phase 3
    starts when all but conv_int8.cu are built, whose nvcc goes on beside
    phases 3-11 and is waited for before phase 12 launches it
 3. kernels: each kernel against its plain PyTorch version at the shapes
    the serving paths give it (f32 and bf16), with kernel, plain-version,
    library-call and bound times and the kernel's multiple of its bound:
    odconv_s2 at the four ODConv sites of the flagship and the four of
    yolo-somi-s (with its launch plan, and the same bits from two bf16
    calls), dcnv2_im2col at rows 6 and 8 and dcnv3_core
    at row 10 of yolo-somi-dcn (with the corner bytes it reads). Every
    timed call starts with a cold L2: a 256 MB buffer is zeroed before it,
    outside the timed events, behind a spin that keeps host launch time
    out of them
 4. serving: the full-width yolo-somi flagship, then the full-width
    yolo-somi-dcn (640 px, bf16, random weights from seed 0; the DCN
    offset/mask heads randomised from seed 0) answer batches of 8 uint8
    images through Runner; each path's kernels must have launched their
    count per batch, with every count set to 0 just before the path. Then
    the rest of the family the same way, each at its published width and
    nc (FAMILY_SERVED: yolo-somi-s and the ODConv ablation through
    odconv_s2 4 times a batch; yolo-somi-t, -t-p3s8 and yolov5s, coupled
    Detect heads, through no kernel, and the four hub detection configs
    of ZOO (yolov3-tiny, yolov5s-ghost, yolov5s-transformer, yolov10) the
    same way; the heads that score nothing above
    0.25 under random weights serve at conf 1e-6, SERVE_CONF, and every
    served image must get a detection), and a sweep (SWEEP): every other
    config the port serves builds at its published width and answers one
    b8 batch, every row finite, no kernel launched
 5. parity: each model in f32 through the kernels is as close to its
    plain version in f64 as the plain version in f32 is, on a batch of 2:
    the flagship, yolo-somi-dcn, yolo-somi-s, yolo-somi-t, yolov5s and ZOO
    (the last six have no kernel site: their f32 distance from f64 is
    printed)
 6. eval, for the flagship, then yolo-somi-dcn with its offset heads
    randomised, then with them at their zero init: val.run of the full-width model (nc 10, 640 px, b8,
    random weights from seed 0) on a self-labelled set. The set is 60 synthetic
    640x480 JPEGs from numpy seed 0 (noise with rectangles and discs drawn
    by numpy masks; 60 = 7 x 8 + 4, so the last batch wraps, and the long
    side is already 640, so the loader pads and never resizes), labelled
    with the top 10 single-label detections (conf > 0.25) of the same
    model in f32 under plain_version(), mapped back to original-image
    normalized xywh. Random weights saturate the head (hundreds of scores
    per image are exactly 1.0, a tie with no ranking), so the head's two
    output convs are scaled by HEAD_TEMPER first. val.run in f32 through
    the kernels must match val.run in f32 under plain_version() (mAP@.5
    within 0.01, mAP@.5:.95 within 0.02, the plain path's mAP@.5 above
    0.5), with the model's kernels launched their count per batch in the
    kernel run (odconv_s2 4; yolo-somi-dcn also dcnv2_im2col 9 and
    dcnv3_core 1) and never in the plain one; then val.run in bf16 through
    the kernels is
    timed (eval line, Speed split, img/s), beside bf16 under
    plain_version() and a split of a bf16 batch into model and NMS
 7. checkpoints and entry points, at full width (640 px, nc 10, bf16):
    the flagship from seed 0 (f32) is exported through the inverse weight
    bridge to a weights file with anchors 1.25 x the config's (~268 MB)
    and stripped to a bf16 copy; Runner(weights=...) must carry those
    anchors, answer a b8 batch with the bits of a seed-0 Runner built with
    them in its config (and other rows than with the config's anchors),
    and the bf16 copy must load to the same parameters. detect.run on 16
    synthetic JPEGs (8 drone frames of 1920x1080, 8 of 640x480; --save-txt
    --save-conf) launches odconv_s2 4 times per image and writes the rows
    the Runner gives on the same letterboxed images, to the printed
    digits. attempt_load([a, a]) answers a b8 batch with the single
    Runner's rows (head tempered, fewer candidates than max_nms / 2) and
    attempt_load([a, b]) launches odconv_s2 8 times per forward. Then
    yolo-somi-dcn, saved with randomised offset heads, is loaded by
    hubconf.yolo_somi_dcn and served by serve.DetectionServer on
    127.0.0.1: 4 JPEGs posted raw and 4 as multipart must get the records
    AutoShape gives directly, with 4 / 9 / 1 launches per forward. Then
    hubconf.yolov5s and hubconf.yolov5l (nc 80, random weights) answer
    AutoShape calls on the 16 JPEGs with no kernel launched, and
    yolo-somi-t, written through export_jax_variables, loads in
    Runner(weights=...) to the bits of the seed-0 model and its rows
 8. training, on a set of 64 train and 16 val synthetic 640x480 JPEGs
    labelled with the shapes drawn in them (rectangle class 0, disc class
    1, nc 10). (a), with phase 3: odconv_s2_dx and odconv_s2_dwmix against
    autograd of the plain version at the four ODConv sites of the flagship
    and of yolo-somi-s (b8), f32 and
    bf16, a bitwise repeat, timed beside the plain version and cuDNN's
    grouped-conv backward, with each bf16 launch plan. (b) one full-width
    f32 train-mode step (b2, seed-0 weights, head tempered) through the
    kernels against the same step under plain_version(), both held against
    the plain step in f64: the loss and the BatchNorm statistics after the
    step within twice the plain f32 step's distance, every parameter's
    gradient within four times the larger of the plain step's distance and
    its median (train_step_parity); non-zero ODConv bank gradients; 4 + 4 +
    4 launches against 0. Then, at b8, the step through the kernels against
    the same step with the plain ODConv backward (in f32, rounded once)
    behind the same forward kernel, in f32 (seeds 0-2) and in bf16 under
    autocast (seeds 0-4): the loss and BatchNorm statistics bitwise, each
    of the step's dx and dwmix launches within GRAD_TOL of the plain
    version on its own inputs, every parameter's gradient within
    WITNESS_TOL relative norm distance (5e-5 in f32; 1 in bf16, whose
    layers carry rounding through, with the median over the parameters held
    to 0.1 and the kernels' step repeated bitwise) (train_step_witness; the
    step run again, cuDNN's bf16 backward and the step under
    plain_version() printed beside it). (c) train.run of the full-width
    flagship (hyp.visdrone, 640 px, b8, bf16, autoanchor on) for 1 epoch,
    then a second from --resume: every logged loss finite, no step skipped
    (the optimizer step counts every step, across the resume), 4 forward +
    4 dx + 4 dwmix launches per train step, the weights files written,
    Runner(last.msgpack) serving a b8 batch; then the train step alone,
    timed and profiled (busy share)
 9. training yolo-somi-dcn, on the same set. (a), with phase 3:
    dcnv2_im2col_bwd at rows 6 and 8 and dcnv3_core_bwd at row 10 against
    autograd of the plain version (b8), f32 and bf16, offsets reaching past
    the border and zero offsets (the heads' init); every call twice, each
    within GRAD_TOL (the input gradient's f32 atomics add in a varying
    order), doffset and dmask the same bits both times; timed beside the
    plain version and grid_sample's backward, with each site's launch plan
    and the share of corners past the plan's windows (added straight to
    global memory). (b) the full-width f32 step (b2) through the kernels
    against plain_version(), both against f64, as 8(b), with the offset
    heads random and at their zero init: every offset head's gradient
    non-zero.
    (c) the b8 witness in bf16 (seeds 0-1), as train.run trains: the step
    through the DCN gradient kernels against the step with their plain
    backward behind the same forward, as 8(b), the repeat held to the same
    limits. (d) train.run as 8(c): 4 + 9 + 1 forward and 4 + 4 + 9 + 1
    gradient launches per train step, 4 + 9 + 1 per val forward
10. the rest of the training recipe, on the same set (one epoch of train.run
    each, hyp.visdrone, b8, bf16, full width, autoanchor off; every step
    synchronised, timed and its peak memory read; STEP_LAUNCHES per step and
    the forward kernels per val forward, every launch a kernel's): (a) the
    flagship with --multi-scale (416-832 px squares), --image-weights,
    --cache ram and --rep; (b) with --rect (480x640 batches); (c) with
    --quad (b2 at 1280 px); (d) yolo-somi-dcn with --cache device (the
    slab, mosaic and mixup, HSV and flips on the device) and
    --multi-scale; (e) one b8 flagship step from the same state with
    --remat 4 and without: peak memory and time of each, the forward kernel
    launched twice a site under remat, BatchNorm statistics and EMA the same
    bits, gradients within the bf16 witness's limits. With phase 3: all
    seven kernels against their plain versions, forward and backward, f32
    and bf16, at the recipe's shapes (a 480x640 batch, an 832 px one, a
    quad 1280 px one of 2), timed with fewer calls (RECIPE_REPS); their
    bf16 sums go into the kernels line as each entry's "recipe" object
11. distillation and evolve, on the same set (hyp.visdrone, b8, bf16,
    full width, autoanchor off): (a) train.run of yolo-somi-t-p3 with
    --teacher (the flagship from seed 0, written as a weights file)
    --teacher-cfg yolo-somi --distill 1.0 --distill-hint 0.5 for one epoch
    and one more from --resume: odconv_s2 4 launches a step (the teacher's
    forward), no gradient kernel, the teacher the same bits after the run,
    the adapters moved, every loss finite, last.ckpt carrying
    kd_adapter_<i>, the resumed run continuing its optimizer step; its
    steps timed beside phase 8's flagship step; (b) the student's step
    alone and distilled, timed and profiled (what the teacher adds); (c)
    --evolve 2 --epochs 1 of the flagship: a row a generation in
    evolve.csv, hyps other than hyp.visdrone's inside META's bounds, 4 + 4
    + 4 launches a step
12. int8, on phase 6's self-labelled set (the flagship, bf16, head
    tempered): (a) conv_int8 at every distinct ConvRaw shape of a b8 batch,
    on the batch's own operands, per tensor and per channel: the fused
    entry (conv_int8_fused, the quantize in the kernel's loads) against
    conv_int8_fused_reference and the int8-input entry against
    conv_int8_reference, the int32 sums and the bf16 outputs the same bits;
    timed (per tensor) beside the fused plain version, torch._int_mm on the
    int8 operands (on x_q's (M, C) view for a 1x1 conv, after an int8
    im2col otherwise; grouped shapes have none) and each entry's bound (the
    fused one reads x in bf16), summed by shape class; (b)
    val.run(int8=True) per tensor, per channel, and per
    channel with the head in bf16, through the kernels, with conv_int8's
    plain version in the kernel's place (the same calibration: mAP@.5
    within 0.01) and under plain_version() (its ODConv moves the
    calibration's absmax, and with it every quantization step, so its mAP
    is printed, not held; the bf16 model's mAP on the f32 labels is itself
    0.04); conv_int8 once per quantized ConvRaw a batch, odconv_s2 4 a
    batch and 4 for the calibration's forward, none under plain_version();
    (c) the seed-0 flagship served in
    int8 through quantized_infer_fn (b8 uint8 batches), timed beside phase
    4's bf16 batch, one batch profiled: conv_int8 once per ConvRaw, and
    aten::div, round and clamp each fewer calls than ConvRaws (the quantize
    passes PyTorch ran before each conv until the kernel took them in)
13. data and pipeline parallelism (parallel/; one card stands in for
    several, so placement itself is not seen): (a) the full-width flagship
    at 640 px, seed-0 weights, head tempered, on DP_WORLD = 2 gloo ranks
    sharing cuda:0 (parallel.mesh.spawn_local; the ranks start while one
    process makes the references they are held against, and wait for
    them; the host time of each part printed): first the semantics, one
    optimizer step through make_train_step(group=) in float64 under
    plain_version() on a global b4, the loss, the momentum buffers and the
    parameter updates within 1e-6 relative of one process's (the loss
    rounds in f32); then, each rank holding b4 of a global b8, 2 steps in f32 and
    then 2 in bf16 under autocast, then one yolo-somi-dcn bf16 step; each
    against one process's b8 steps from the same weights (the first loss
    within 2e-4 relative in f32, 1e-1 in bf16, the first step's moves of
    the first 2 BatchNorms' statistics within 1e-4; the gradient, update and
    parameter distances printed: the seed-0 full-width step amplifies the
    forwards' different rounding past any fixed limit, DP_LOSS's comment);
    both ranks the same parameter bits, each rank launching
    odconv_s2, odconv_s2_dx and odconv_s2_dwmix 4 times a step (DCN: 9 + 1
    forward and backward too), the counts set to 0 just before each job;
    (b) torchrun --standalone --nproc_per_node 1 -m yolosomi_tpu_torch.train
    over NCCL, one epoch of the flagship on phase 8's set: one last.ckpt,
    the epoch's kernel launches from train_log.jsonl; (c) PipelineTrainer
    of the full-width flagship in 2 stages on cuda:0: at microbatch 8 its
    loss and gradients against one process's f32 step (1e-5; phase 8's f32
    witness limits), at microbatch 2 a finite step with the optimizer and
    its per-stage parameter bytes, and pipeline_infer against the model's
    forward of the same microbatches; step times beside the card's name
    and power limit
14. spatial sharding (parallel/spatial.py; one card stands in for two):
    dcnv2_im2col and dcnv3_core at yolo-somi-dcn's sites (b2, 640 px) on
    the second strip's output rows (row0 half the rows) against their plain
    versions at row0, bitwise the whole call's rows and in f32 against
    grid_sample at the strip's points, timed beside the whole call and
    grid_sample and bounded by the map rows the strip's points touch;
    odconv_s2 against its plain version at the shapes each strip gives it
    (its rows plus the two above); then the full-width flagship at b2
    1280x1280 and
    yolo-somi-dcn at b2 640 px (seed 0, head tempered, offset heads
    randomised), each in f32 (TF32 off) and bf16, served in one process and
    then over SP_WORLD = 2 H-strips on gloo ranks sharing cuda:0: every
    rank's launches per forward (4; DCN 4 + 9 + 1), the counts set to 0
    just before the forward; both ranks the same rows; in f32 and bf16 the
    sharded head maps no further from the float64 model (under
    plain_version()) than twice the unsharded model of the same dtype is
    (phase 5's rule), in f32 the rows too, as many kept; per-rank peak
    memory, batch times and the bytes each rank all-reduces, beside one
    process's peak and its largest allocation
15. test-time augmentation (the 0.83 and 0.67 passes' canvases are 544
    and 448 px): odconv_s2 at the flagship's four sites and dcnv2_im2col /
    dcnv3_core at yolo-somi-dcn's on those canvases against their plain
    versions, timed as in phase 3; TTA serving (b8, 640 px, bf16, seed 0,
    DCN offset heads randomised) of the flagship and yolo-somi-dcn, with
    odconv_s2 12 launches a batch (yolo-somi-dcn 12 / 27 / 3) and the
    counts set to 0 just before each path, timed beside plain batches of
    the same Runner; TTA's decoded rows of a b2 batch in f32 through the
    kernels no further from the float64 model (plain_version(), the same
    TTA, a float64 decode) than twice the plain f32 rows (phase 5's rule);
    val.run(augment=True) of the flagship in f32 on phase 6's set,
    kernels against plain_version() (mAP@.5 within 0.01, 12 launches a
    batch against 0); detect.run(augment=True) on 4 of phase 7's JPEGs
    writes Runner(augment=True)'s rows; detect.run(classify="classifier")
    on them: classifier.yaml's headless model at 224 px gives finite
    logits, and the rows it keeps are among the unfiltered rows
16. the rest of the heads, each in place of row 35 on the full-width
    flagship body (rows 0-34, nc 10, 640 px, HEAD_ROWS): DetectV8,
    DetectV11, IDetect, IAuxDetect, ASFF_Detect, CLLADetect,
    TSCODE_Detect, DetectODConv, Segment (nm 32, npr 256) and
    RTDETRDecoder (hd 256, nq 300). (a) each serves HEAD_REQUESTS b8 bf16
    batches through Runner (conf 1e-6, every image answered), odconv_s2 4
    times a batch with the counts set to 0 just before, latency, img/s and
    the model / postprocess split printed; its f32 model through the
    kernels no further from f64 than twice the plain f32 model (phase 5's
    rule; RT-DETR's head input maps). (b) flagship+DetectV8 through
    ComputeLossV8 on phase 8's set: HEAD_STEPS timed bf16 b8 steps with
    4 + 4 + 4 launches each, peak memory and the assigner's tensor size,
    one step profiled, the f32 b2 step against plain_version() (phase
    8(b)'s rule); one flagship+IAuxDetect bf16 b8 step through
    ComputeLoss's aux branch (8 maps), 4 + 4 + 4 launches. DetectV8's
    biases take the ultralytics head's init first (dfl_prior: the JAX
    init_model sets none, and from zero biases the third step diverges)
17. the body zoo's graphs (yolosomi_tpu_torch/models/zoo_graphs.py: the
    full-width flagship, nc 10, with CARAFE upsamples; with sub-pixel
    Expand, DySample and Zoom_cat; with BiFPN_Add2 / 3, MultiSEAM and the
    learnable activations; with SPD-Conv, MixConv2d, GSConv and CrossConv;
    with the CSP variants and SPPCSPC; with the gates, a repeated CBAM row
    and Involution; with layers.py's attention gates (zoo-gates2); with
    its global attentions and SPPF_LSKA (zoo-global); with C3STR, a Swin
    block, HorBlock and gnconv (zoo-swin); with C3RFEM, RFEM, LVCBlock and
    ConvMixer (zoo-rfem); with layers_zoo.py's SimConv, ADown, DownSimper,
    RepVGGBlock, SPPELAN, CoordConv / CoordConvd, SPPF_improve and ASPP
    (zoo-down); with CNeB, the RFB blocks, SPPCSPCS, ACmix, Conv_SWS, CSPCM
    and C3CR (zoo-rfb); with the C3 blocks with attention bottlenecks,
    CPCA, C2fBAM, C2f_DWR and VoVGSCSPCBAM (zoo-c3att); with layers_zoo.py's
    transposed-conv upsamplers, n-ary merges, context and HS-FPN gates,
    Conv2Former, the sliced SimAMs, C3CBAM, ConvMix and a standalone
    BatchNorm (zoo-tconv); with BiFusion, BiFPNs, SF, SDI, BiFPNSDI, ScalSeq,
    attention_model and CAM (zoo-asf)), each keeping the four ODConv sites. (a) each serves
    HEAD_REQUESTS b8 bf16 batches through Runner as phase 16(a) serves a head
    (conf 1e-6, every image answered, odconv_s2 4 times a batch with the
    counts set to 0 just before; params, latency, img/s, the model /
    postprocess split and the peak memory printed), its f32 b2 model
    through the kernels no further from f64 than twice the plain f32 model
    (phase 5's rule); zoo-global, whose MHSA takes the map's size at
    build, from a weights file built at 640 px. (b) zoo-fusion, zoo-rfem,
    zoo-c3att and zoo-asf (head tempered) through ComputeLoss on phase 8's set:
    ZOO_STEPS timed bf16 b8 steps with 4 + 4 + 4 launches each and the
    peak memory, then the f32 b2 step against plain_version() (phase
    8(b)'s rule)
The last three lines are the card, the kernel summary and the device JSON.
Longer tables (the profilers' kernel breakdowns) go to chiprun_out/.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import itertools
import json
import logging
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import cv2
import numpy as np
import torch
import torch.nn.functional as F
import yaml

from yolosomi_tpu_torch import detect, hubconf, train, val
from yolosomi_tpu_torch.data.datasets import DataLoader, DetectionDataset, LoadImages, pad_targets
from yolosomi_tpu_torch.engine.checkpoint import save_variables, strip_checkpoint
from yolosomi_tpu_torch.engine.distill import plant_adapters, wrap_loss_with_distillation
from yolosomi_tpu_torch.engine.evolve import META
from yolosomi_tpu_torch.engine.optim import make_optimizer
from yolosomi_tpu_torch.engine.runner import ANCHOR_HEADS, EnsembleRunner, Runner, attempt_load
from yolosomi_tpu_torch.engine.trainer import TrainStep, create_train_state, make_train_step, upload_images
from yolosomi_tpu_torch.losses import ComputeLoss
from yolosomi_tpu_torch.losses_v8 import ComputeLossV8
from yolosomi_tpu_torch.models.layers import FlaxBatchNorm1d, FlaxBatchNorm2d, ODConv2d
from yolosomi_tpu_torch.models.dcn import DCNv2, DCNv3, randomize_offset_heads
from yolosomi_tpu_torch.models.heads import _grid_boxes, decode
from yolosomi_tpu_torch.models.yolo import build_model, parse_model
from yolosomi_tpu_torch.models.zoo_graphs import ZOO_GRAPHS, zoo_graph
from yolosomi_tpu_torch.ops import build, quant
from yolosomi_tpu_torch.ops.dcn import (Dcnv2Im2colFunction, Dcnv3CoreFunction, _v2_bwd_plan, _v3_bwd_plan,
                                        dcnv2_im2col, dcnv2_im2col_backward_reference, dcnv2_im2col_bwd,
                                        dcnv2_im2col_reference, dcnv3_core, dcnv3_core_backward_reference,
                                        dcnv3_core_bwd, dcnv3_core_reference, dcnv3_points)
from yolosomi_tpu_torch.ops.int8 import (_conv_int8_plan, conv_int8, conv_int8_fused, conv_int8_fused_reference,
                                         conv_int8_reference, quantize_activation)
from yolosomi_tpu_torch.ops.nms import fused_postprocess, non_max_suppression
from yolosomi_tpu_torch.ops.tta import TTA_SCALES, forward_augment
from yolosomi_tpu_torch.ops.odconv import (OdconvS2Function, _dw_plan, _dw_split, _dx_plan, _plan, odconv_s2,
                                           odconv_s2_backward_reference, odconv_s2_dwmix, odconv_s2_dx,
                                           odconv_s2_reference, plain_version)
from yolosomi_tpu_torch.parallel import mesh
from yolosomi_tpu_torch.parallel.pipeline import PipelineTrainer, pipeline_infer
from yolosomi_tpu_torch.parallel.spatial import strip_plan
from yolosomi_tpu_torch.serve import DetectionServer
from yolosomi_tpu_torch.utils.boxes import scale_coords, xyxy2xywhn
from yolosomi_tpu_torch.utils.config import find_config, load_hyp, load_model_cfg
from yolosomi_tpu_torch.utils.general import LOGGER
from yolosomi_tpu_torch.utils.msgpack import msgpack_restore
from yolosomi_tpu_torch.utils.weights import conv_raw_paths, export_jax_variables

IMGSZ = 640
BATCH = 8
N_REQUESTS = 10
HEAD_REQUESTS = 5  # phases 16-17: 25 graphs, each a Runner of its own
# phase 13(a) and 13(c)'s times share the card with 13(b)'s process
CONTENDED = "taken while phase 13(b)'s torchrun epoch trains on the same card"
# H100 SXM data-sheet peaks (dense): bf16 and int8 tensor cores, f32 without them, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
PEAK_BYTES = 3.35e12
OUT = Path("chiprun_out")
SOURCES = ("odconv_s2.cu", "dcn.cu", "odconv_s2_bwd.cu", "dcn_bwd.cu", "conv_int8.cu")
KERNELS = (odconv_s2, dcnv2_im2col, dcnv3_core, odconv_s2_dx, odconv_s2_dwmix, dcnv2_im2col_bwd, dcnv3_core_bwd,
           conv_int8)
# launches per served batch on each path; any other config launches none
PER_BATCH = {
    "yolo-somi": {"odconv_s2": 4},
    "yolo-somi-dcn": {"odconv_s2": 4, "dcnv2_im2col": 9, "dcnv3_core": 1},
    "yolo-somi-s": {"odconv_s2": 4},
    "ablation/v5s-c2f-odconv-bifpn-p2-decoupled": {"odconv_s2": 4},
}
# the rest of the family served as the flagship is (phase 4), at its
# published width and depth, with its YAML's nc (10 for the SOMI configs,
# 80 for the YOLOv5 ones)
FAMILY_SERVED = {"yolo-somi-s": (0.5, 0.67), "ablation/v5s-c2f-odconv-bifpn-p2-decoupled": (0.5, 0.33),
                 "yolo-somi-t": (1.0, 1.0), "yolo-somi-t-p3s8": (1.0, 1.0), "yolov5s": (0.5, 0.33),
                 "hub/yolov3-tiny": (1.0, 1.0), "hub/yolov5s-ghost": (0.5, 0.33),
                 "hub/yolov5s-transformer": (0.5, 0.33), "hub/yolov10": (1.0, 1.0)}
# the hub configs of the Ghost, transformer and YOLOv10 blocks and yolov3-tiny's pool and pad (phase 4 serves them,
# phase 5 prints their distance)
ZOO = ("hub/yolov3-tiny", "hub/yolov5s-ghost", "hub/yolov5s-transformer", "hub/yolov10")
# every other config the port serves: each builds and answers one b8 batch
SWEEP = ("yolo-somi-t-p3", "yolo-somi-t-p3s", "ablation/v5s-c2f", "ablation/v5s-c2f-bifpn-p2", "yolov5n", "yolov5m",
         "yolov5l", "yolov5x", "yolov5s-p2", "yolov5s6", "yolov5n6", "hub/yolov5s6", "yolov5m6", "yolov5l6",
         "yolov5x6", "yolov5-p2", "yolov5-p6", "yolov5-p7", "yolov5-bifpn", "yolov5-fpn", "yolov5-panet", "yolov3",
         "yolov3-spp")
PARITY = ("yolo-somi", "yolo-somi-dcn", "yolo-somi-s", "yolo-somi-t", "yolov5s", *ZOO)
# AutoShape's threshold for the yolov5 hub loaders: random weights under
# the detection priors score ~1e-4 at most, so the usual 0.25 (or 0.001)
# would return no box to map back to the images
HUB_CONF = 1e-6
# the serving threshold (phase 4), Runner's 0.25 unless named here: these
# heads score nothing above 0.25 under random weights and the priors, so
# they serve at HUB_CONF and their NMS takes its full top-4096 candidates,
# as the flagship's does at 0.25
SERVE_CONF = {name: HUB_CONF for name in ("ablation/v5s-c2f-odconv-bifpn-p2-decoupled", "yolo-somi-t",
                                          "yolo-somi-t-p3s8", "yolov5s", *ZOO)}
EVAL_IMAGES = 60  # 7 batches of 8 and a last one that wraps 4
EVAL_TOP = 10  # labels per image
HEAD_TEMPER = 0.1
EVAL_NMS = dict(conf_thres=0.001, iou_thres=0.6, max_nms=30000, multi_label=True)  # val.run's protocol
ANCHOR_SCALE = 1.25  # the checkpoint's anchors against the config's
DETECT_IMAGES = ((8, 1080, 1920), (8, 480, 640))  # (count, h, w): drone frames, then VGA
N_POSTS = 4  # images posted to the server, each raw and as multipart
ENSEMBLE_CONF = 0.1  # the twin-ensemble check's threshold
TRAIN_IMAGES, VAL_IMAGES = 64, 16  # the training phase's self-drawn set, 640x480
TRAIN_EPOCHS = 1  # then one more from --resume
# launches of one train step (forward and backward) of each full-width model
STEP_LAUNCHES = {
    "yolo-somi": dict(odconv_s2=4, odconv_s2_dx=4, odconv_s2_dwmix=4),
    "yolo-somi+DetectV8": dict(odconv_s2=4, odconv_s2_dx=4, odconv_s2_dwmix=4),
    "zoo-fusion": dict(odconv_s2=4, odconv_s2_dx=4, odconv_s2_dwmix=4),
    "zoo-rfem": dict(odconv_s2=4, odconv_s2_dx=4, odconv_s2_dwmix=4),
    "zoo-c3att": dict(odconv_s2=4, odconv_s2_dx=4, odconv_s2_dwmix=4),
    "zoo-asf": dict(odconv_s2=4, odconv_s2_dx=4, odconv_s2_dwmix=4),
    "yolo-somi-dcn": dict(odconv_s2=4, odconv_s2_dx=4, odconv_s2_dwmix=4, dcnv2_im2col=9, dcnv3_core=1,
                          dcnv2_im2col_bwd=9, dcnv3_core_bwd=1),
}
# the gradient kernels against autograd of the plain version, relative
# norm of the difference: f32 sums in another order (measured 3e-7 to
# 2e-6); bf16 rounds the output once (2**-9 relative, 1.7e-3 measured)
GRAD_TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-3}
# the full-width f32 step through the kernels against plain_version(), both
# against f64: the floor for gradients that are zero in exact arithmetic, as
# a share of the largest gradient's norm (train_step_parity)
STEP_GRAD_TOL = 1e-6
# the same step's loss and BatchNorm statistics are held to twice the plain
# f32 step's distance from f64 plus a floor: the loss's as a share of the
# loss, the statistics' relative. A single scalar's distance is a noisy
# yardstick: the kernels' and the plain f32 forward differ by 1e-5 to 4e-5
# of the loss and 2.5e-4 to 4e-4 in the statistics (the witness lines of
# phase 8b, and 9.6e-6 / 2.2e-4 for yolo-somi-dcn at the zero init, NVIDIA
# H100 80GB HBM3), so for yolo-somi-dcn each floor is that noise; the
# flagship keeps the floor it passed with (1e-6)
STEP_FLOORS = {"yolo-somi": (1e-6, 1e-6), "yolo-somi-dcn": (2e-5, 5e-4), "yolo-somi+DetectV8": (1e-6, 1e-6),
               "zoo-fusion": (1e-6, 1e-6), "zoo-rfem": (1e-6, 1e-6), "zoo-c3att": (1e-6, 1e-6),
               "zoo-asf": (1e-6, 1e-6)}
# the per-parameter floor of that comparison, as a share of the largest
# gradient's norm: STEP_GRAD_TOL for the flagship; for yolo-somi-dcn the
# bf16 witness's 1e-4, because its f32 step through the kernels put a sum
# that cancels (row 2's CBAM spatial-attention bias, 4.2e-2 against
# gradients of hundreds) 35% from f64 where the plain step put it 3.3% (at
# the zero init, NVIDIA H100 80GB HBM3): the forward kernels' rounding,
# carried into a cancelling sum. For that model the median distance over
# all parameters is held to STEP_MEDIAN_RATIO times the plain step's too.
STEP_PARAM_FLOOR = {"yolo-somi": STEP_GRAD_TOL, "yolo-somi-dcn": 1e-4, "yolo-somi+DetectV8": STEP_GRAD_TOL,
                    "zoo-fusion": STEP_GRAD_TOL, "zoo-rfem": STEP_GRAD_TOL, "zoo-c3att": STEP_GRAD_TOL,
                    "zoo-asf": STEP_GRAD_TOL}
STEP_MEDIAN_RATIO = 2.0
# the configs whose comparison takes a second draw of the rounding noise
# beside the plain f32 step: the plain step from parameters nudged by one
# ulp (x (1 + 2**-23)); each parameter's yardstick is the larger of the two
# distances, the median the larger median. zoo-fusion's
# gradients are chaotic at that level: the plain step lay a median 0.100 of
# each gradient from f64, the nudged plain step 0.200 and the kernels' 0.211,
# and the nudged step alone failed the one-draw rule at 5 parameters (its
# first BatchNorm-fed attention convs and ODConv's fc_w bias), 4 of them
# among the kernels' 8 (probe_step_noise.py; NVIDIA H100 80GB HBM3,
# 700.00 W; the flagship's steps: 0.034 plain, 0.011 nudged, 0.018
# kernels, none over the rule). zoo-asf's nudged plain step, a median 0.059
# from f64 (plain 0.039, kernels 0.050), failed the one-draw rule at 2 of 735
# parameters, the backbone's CBAM spatial gates (model.4.m.5's weight and
# bias), and the kernels' step at 2 (model.4.m.5's bias, model.6.m.4's
# weight; probe_step_noise.py zoo-asf, the same card)
STEP_SECOND_DRAW = {"zoo-fusion", "zoo-asf"}
# the same step at b8 through the kernels against the plain ODConv backward
# (in f32, rounded once) behind the same forward kernel (train_step_witness),
# in f32 for WITNESS_SEEDS[float32] and in bf16 under autocast for
# WITNESS_SEEDS[bfloat16]: each parameter's gradient within WITNESS_TOL
# relative norm distance plus WITNESS_FLOOR times the largest gradient's
# norm. f32: the least limit that passed was 1.4e-6 to 6.2e-6 over seeds
# 0-4 on the H100, and the limit is 8x the largest; the kernels' step run
# twice differs by as much (median 2.1e-6: the graph's own run-to-run
# noise), and the floor is STEP_GRAD_TOL. bf16: the bf16 layers behind the
# ODConvs turn the few gradient elements that round the other way into
# percent-level gradient differences, largest in sums that cancel to 1e-4
# of the largest gradient (CBAM's spatial-attention convs, ODConv's
# attention fc); cuDNN's bf16 backward lies as far from the f32-rounded
# one. The reference is computed with cuDNN's deterministic algorithms
# (plain_backward): with the default ones its bits changed from one process
# to the next while the kernels' step and cuDNN's bf16 one did not, and a
# spatial-attention bias's distance changed with them (seed 0's
# model.2.m.1.spatial_attention.cv1.bias: within the limit in one run, 0.33
# from a 0.04 norm, over it, in another). With a floor of 1e-4 of the
# largest gradient, the least limit that passes the deterministic
# reference is 0.06 to 0.23 over seeds 0-4, the same bits in every
# process, and the limit is 1: it catches a wrong gradient, not rounding.
# The tight bf16 checks are the median over the parameters, 1.9e-2 to
# 3.0e-2 (cuDNN's bf16 backward: 1.8e-2 to 2.9e-2), held to
# WITNESS_MEDIAN_TOL (a kernel composed wrongly into the step moves it to
# order 1), the kernels' step repeated bitwise, and each gradient kernel's
# output in the step within GRAD_TOL of the plain version on its own inputs
WITNESS_SEEDS = {torch.float32: (0, 1, 2), torch.bfloat16: (0, 1, 2, 3, 4)}
WITNESS_TOL = {torch.float32: 5e-5, torch.bfloat16: 1.0}
WITNESS_FLOOR = {torch.float32: STEP_GRAD_TOL, torch.bfloat16: 1e-4}
WITNESS_MEDIAN_TOL = 0.1
# the same witness for yolo-somi-dcn, its DCN gradient kernels against the
# plain backward (phase 9c), in bf16 as train.run trains. Not in f32: there
# the limit (5e-5) is below what one DCNv3 point does whose kernel and
# plain coordinates, an ulp apart, floor to different corners (one in
# ~1e5 at random offsets), where doffset jumps
DCN_WITNESS_SEEDS = {torch.float32: (), torch.bfloat16: (0, 1)}


# numbers later phases print beside their own: phase 4's serving latency
# (s per batch) by config, phase 8's train step (s) and train.run peak
# memory (bytes) by config
RECORD = {}


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


_FLUSH = []
TIME_REPS = [20]  # timed calls of time_ms; phase 10 times its extra shapes with fewer (recipe_kernels)


def time_ms(fn, reps: int = None, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, after warm-up. Before each timed
    call, outside its events, a 256 MB buffer (5x the H100's 50 MB L2) is
    zeroed, so every call reads its inputs from HBM as the serving path's
    first touch does. Ahead of the flush the card spins for ~2 ms, so the
    host has queued the whole call before the start event runs: the host's
    launch overhead, which varies from machine to machine, stays outside
    the events."""
    if not _FLUSH:
        _FLUSH.append(torch.empty(256 << 20, dtype=torch.uint8, device="cuda"))
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps or TIME_REPS[0]):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1 << 22)
        _FLUSH[0].zero_()
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def odconv_sites(meta, batch: int, imgsz):
    """(row, x shape, wmix shape) of every ODConv row of the graph on a
    batch of `imgsz` (a side, or (h, w))."""
    h, w = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
    sites = []
    for spec in meta.specs:
        if spec.name in ("ODConv", "ODConv_3rd"):
            src = meta.specs[spec.i + spec.f if spec.f < 0 else spec.f]
            xs = (batch, int(h / src.stride), int(w / src.stride), src.c2)
            sites.append((spec.i, xs, (batch, 3, 3, src.c2, spec.c2)))
    return sites


def bound_ms(x: torch.Tensor, wmix: torch.Tensor) -> tuple:
    """Least time for this call: each input read once, the output written
    once, over HBM bandwidth; the conv's FLOPs over the dtype's peak."""
    B, H, W, C = x.shape
    cout = wmix.shape[-1]
    m = (H // 2) * (W // 2)
    nbytes = (x.numel() + wmix.numel() + B * m * cout) * x.element_size()
    return roofline(nbytes, 2.0 * B * m * cout * 9 * C, PEAK_FLOPS[x.dtype])


def roofline(nbytes: float, flops: float, peak_flops: float) -> tuple:
    """(bound ms, what bounds it, bytes ms, operations ms)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_flops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_bytes, t_ops


def new_summary() -> dict:
    return {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "t_bytes": 0.0, "t_ops": 0.0,
            "max_abs_err": 0.0}


def add_site(summary: dict, count: int, kernel_ms, plain_ms, library_ms, bound, err) -> None:
    """Add one site's bf16 numbers, times its launches per served batch."""
    b_ms, _, t_bytes, t_ops = bound
    for key, v in (("ms", kernel_ms), ("plain_ms", plain_ms), ("library_ms", library_ms), ("bound_ms", b_ms),
                   ("t_bytes", t_bytes), ("t_ops", t_ops)):
        summary[key] += count * v
    summary["max_abs_err"] = max(summary["max_abs_err"], err)


def check_kernel(sites, gen: torch.Generator, cfg_name: str = "yolo-somi") -> dict:
    """odconv_s2 against odconv_s2_reference at every site of `cfg_name`,
    f32 and bf16."""
    summary = new_summary()
    for row, xs, ws in sites:
        x32 = torch.randn(xs, device="cuda", generator=gen)
        w32 = torch.randn(ws, device="cuda", generator=gen) * (2.0 / (9 * xs[-1])) ** 0.5
        for dtype in (torch.float32, torch.bfloat16):
            x, w = x32.to(dtype), w32.to(dtype)
            got = odconv_s2(x, w)
            torch.cuda.synchronize()
            ref = odconv_s2_reference(x.float(), w.float())
            err = (got.float() - ref).abs().max().item()
            tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else dict(atol=0.15, rtol=0.03)
            torch.testing.assert_close(got.float(), ref, **tol)
            plan = ""
            if dtype == torch.bfloat16:
                assert torch.equal(odconv_s2(x, w), got), f"row {row}: two calls disagree"
                plan = " plan (tiles {}, split {})".format(*_plan(*xs, ws[-1]))
            kernel_ms = time_ms(lambda: odconv_s2(x, w))
            plain_ms = time_ms(lambda: odconv_s2_reference(x, w))
            # the library call alone: one grouped conv on inputs already in its layout
            B, H, W, C = x.shape
            cout = w.shape[-1]
            xg = x.permute(0, 3, 1, 2).reshape(1, B * C, H, W).contiguous()
            wg = w.permute(0, 4, 3, 1, 2).reshape(B * cout, C, 3, 3).contiguous()
            library_ms = time_ms(lambda: F.conv2d(xg, wg, stride=2, padding=1, groups=B))
            bound = bound_ms(x, w)
            print(f"odconv_s2 {cfg_name} row {row} x{tuple(xs)} cout {ws[-1]} {str(dtype)[6:]}{plan}: kernel_ms "
                  f"{kernel_ms:.4f} "
                  f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} bound_ms {bound[0]:.4f} ({bound[1]}) "
                  f"x bound {kernel_ms / bound[0]:.1f} max_abs_err {err:.3e}")
            if dtype == torch.bfloat16:  # the serving path's dtype
                add_site(summary, 1, kernel_ms, plain_ms, library_ms, bound, err)
    return summary


# ---------------------------------------------------------------------------
# the deformable sampling kernels
# ---------------------------------------------------------------------------

# f32: the kernels' closed-form coordinates differ from the plain versions'
# (and grid_sample's) in the last bits; the sampling is continuous, so that
# costs ~ulp(px) times the map's slope, well under 1e-4. bf16: the same
# bf16 inputs on both sides, f32 interpolation, one rounding of outputs of
# a few units (2**-9 relative).
DCN_TOL = {torch.float32: dict(atol=1e-4, rtol=1e-4), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}


def dcn_sites(cfg_name: str, batch: int, imgsz):
    """The DCNv2 sites (row, launches per batch, x shape, k, s, p) and the
    DCNv3 sites (row, 1, input shape, G, k, s, pad, dil) of a graph on a
    batch of `imgsz` (a side, or (h, w)), read from its modules (built on
    the meta device, so nothing is allocated)."""
    h, w = (imgsz, imgsz) if isinstance(imgsz, int) else imgsz
    with torch.device("meta"):
        modules, meta = parse_model(load_model_cfg(find_config(cfg_name)))
    v2, v3 = [], []
    for spec, mod in zip(meta.specs, modules):
        if not isinstance(spec.f, int) or spec.i + spec.f < 0:  # fusion rows, the image
            continue
        src = meta.specs[spec.i + spec.f if spec.f < 0 else spec.f]
        hw = (int(h / src.stride), int(w / src.stride))
        convs = [m for m in mod.modules() if isinstance(m, DCNv2)]
        if convs:
            geometry = {(m.conv_offset_mask.in_channels, m.k, m.s, m.p) for m in convs}
            assert len(geometry) == 1, geometry
            c, k, s, p = geometry.pop()
            v2.append((spec.i, len(convs), (batch, *hw, c), k, s, p))
        if isinstance(mod, DCNv3):
            v3.append((spec.i, 1, (batch, *hw, src.c2), mod.group, mod.k, mod.stride, mod.pad, mod.dilation))
    return v2, v3


def valid_corners(px: torch.Tensor, py: torch.Tensor, H: int, W: int) -> int:
    """Bilinear corners of these points that lie on the H x W map: the taps
    the kernels load and multiply (the others count zero)."""
    x0, y0 = px.floor(), py.floor()
    n = 0
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        n += ((x0 + dx >= 0) & (x0 + dx <= W - 1) & (y0 + dy >= 0) & (y0 + dy <= H - 1)).sum().item()
    return n


def grid_of(px: torch.Tensor, py: torch.Tensor, H: int, W: int, dtype) -> torch.Tensor:
    """Pixel coordinates -> grid_sample's normalised ones (align_corners=False)."""
    return torch.stack([(2 * px + 1) / W - 1, (2 * py + 1) / H - 1], -1).to(dtype)


def check_dcnv2(sites, gen: torch.Generator) -> dict:
    """dcnv2_im2col against dcnv2_im2col_reference at every DCNv2 site, f32
    and bf16, offsets up to +-4 px (fractional, some off the map)."""
    summary = new_summary()
    for row, count, xs, k, s, p in sites:
        N, H, W, C = xs
        Ho, Wo, P = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1, k * k
        x32 = torch.randn(xs, device="cuda", generator=gen)
        oy32, ox32 = ((torch.rand((2, N, Ho, Wo, P), device="cuda", generator=gen) - 0.5) * 8).unbind(0)
        m32 = torch.sigmoid(torch.randn((N, Ho, Wo, P), device="cuda", generator=gen))
        kk = torch.arange(k, device="cuda")
        py = (torch.arange(Ho, device="cuda") * s - p)[None, :, None, None] + kk.repeat_interleave(k) + oy32
        px = (torch.arange(Wo, device="cuda") * s - p)[None, None, :, None] + kk.repeat(k) + ox32
        flops = 2.0 * C * valid_corners(px, py, H, W)
        for dtype in (torch.float32, torch.bfloat16):
            x, oy, ox, m = (t.to(dtype).contiguous() for t in (x32, oy32, ox32, m32))
            got = dcnv2_im2col(x, oy, ox, m, k, s, p)
            torch.cuda.synchronize()
            ref = dcnv2_im2col_reference(x.float(), oy.float(), ox.float(), m.float(), k, s, p)
            err = (got.float() - ref).abs().max().item()
            torch.testing.assert_close(got.float(), ref, **DCN_TOL[dtype])
            # the nearest single library call: grid_sample over the same
            # points, sampling only (no mask product, no column layout)
            xin = x.permute(0, 3, 1, 2).contiguous()
            grid = grid_of(px, py, H, W, dtype).reshape(N, Ho * Wo, P, 2)
            library = lambda: F.grid_sample(xin, grid, mode="bilinear", padding_mode="zeros",  # noqa: E731
                                            align_corners=False)
            if dtype == torch.float32:  # an independent check of the sampling points
                alt = (library() * m.reshape(N, 1, Ho * Wo, P)).permute(0, 2, 3, 1).reshape(N, Ho * Wo, P * C)
                torch.testing.assert_close(got, alt, **DCN_TOL[dtype])
            kernel_ms = time_ms(lambda: dcnv2_im2col(x, oy, ox, m, k, s, p))
            plain_ms = time_ms(lambda: dcnv2_im2col_reference(x, oy, ox, m, k, s, p))
            library_ms = time_ms(library)
            nbytes = (x.numel() + 3 * oy.numel() + got.numel()) * x.element_size()
            bound = roofline(nbytes, flops, PEAK_FLOPS[torch.float32])  # f32 FMAs in every dtype
            print(f"dcnv2_im2col row {row} x{tuple(xs)} cols {tuple(got.shape)} x{count}/batch {str(dtype)[6:]}: "
                  f"kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} "
                  f"(grid_sample, sampling only, no mask product) bound_ms {bound[0]:.4f} ({bound[1]}; "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e6:.0f} MFLOP) x bound {kernel_ms / bound[0]:.1f} "
                  f"max_abs_err {err:.3e}")
            if dtype == torch.bfloat16:
                add_site(summary, count, kernel_ms, plain_ms, library_ms, bound, err)
    return summary


def dcnv3_site(site, gen: torch.Generator) -> dict:
    """f32 inputs of one DCNv3 site, offsets up to +-4 px and softmax masks,
    and the kernel's sampling points: bx, by the offset-free pixel
    coordinates of every (pixel, group, point) in the kernel's closed form
    (p = ix*k + iy), px, py the sampled ones."""
    _, _, xs, G, k, s, pad, dil = site
    N, H, W, C = xs
    P = k * k
    Ho = (H + 2 * pad - (dil * (k - 1) + 1)) // s + 1
    Wo = (W + 2 * pad - (dil * (k - 1) + 1)) // s + 1
    v32 = torch.randn(xs, device="cuda", generator=gen)
    o32 = (torch.rand((N, Ho, Wo, G * P * 2), device="cuda", generator=gen) - 0.5) * 8
    m32 = torch.softmax(torch.randn((N, Ho, Wo, G, P), device="cuda", generator=gen) * 2, -1)
    half = (dil * (k - 1)) // 2
    pp = torch.arange(P, device="cuda")
    off = o32.reshape(N, Ho, Wo, G, P, 2)
    bx = (half + torch.arange(Wo, device="cuda") * s - pad)[None, None, :, None, None] + (pp // k) * dil - half
    by = (half + torch.arange(Ho, device="cuda") * s - pad)[None, :, None, None, None] + (pp % k) * dil - half
    return dict(v32=v32, o32=o32, m32=m32.reshape(N, Ho, Wo, G * P), bx=bx, by=by, px=bx + off[..., 0],
                py=by + off[..., 1], shape=(N, H, W, G, C // G, Ho, Wo, P),
                args=(k, k, s, s, pad, pad, dil, dil, G, C // G))


def check_dcnv3(sites, gen: torch.Generator) -> dict:
    """dcnv3_core against dcnv3_core_reference at every DCNv3 site, f32 and
    bf16, offsets up to +-4 px and softmax masks."""
    summary = new_summary()
    for site in sites:
        row, count, xs = site[:3]
        d = dcnv3_site(site, gen)
        N, H, W, G, Cg, Ho, Wo, P = d["shape"]
        px, py, args = d["px"], d["py"], d["args"]
        corners = valid_corners(px, py, H, W)
        flops = 2.0 * Cg * corners
        for dtype in (torch.float32, torch.bfloat16):
            v, o, m = (d[key].to(dtype).contiguous() for key in ("v32", "o32", "m32"))
            got = dcnv3_core(v, o, m, *args)
            torch.cuda.synchronize()
            ref = dcnv3_core_reference(v.float(), o.float(), m.float(), *args)
            err = (got.float() - ref).abs().max().item()
            torch.testing.assert_close(got.float(), ref, **DCN_TOL[dtype])
            vin = v.reshape(N, H, W, G, Cg).permute(0, 3, 4, 1, 2).reshape(N * G, Cg, H, W).contiguous()
            grid = grid_of(px, py, H, W, dtype).permute(0, 3, 1, 2, 4, 5).reshape(N * G, Ho * Wo, P, 2)
            library = lambda: F.grid_sample(vin, grid, mode="bilinear", padding_mode="zeros",  # noqa: E731
                                            align_corners=False)
            if dtype == torch.float32:  # an independent check of the sampling points and their order
                mg = m.reshape(N, Ho * Wo, G, P).permute(0, 2, 1, 3).reshape(N * G, 1, Ho * Wo, P)
                alt = (library() * mg).sum(-1).reshape(N, G, Cg, Ho, Wo).permute(0, 3, 4, 1, 2).reshape(got.shape)
                torch.testing.assert_close(got, alt, **DCN_TOL[dtype])
            kernel_ms = time_ms(lambda: dcnv3_core(v, o, m, *args))
            plain_ms = time_ms(lambda: dcnv3_core_reference(v, o, m, *args))
            library_ms = time_ms(library)
            nbytes = (v.numel() + o.numel() + m.numel() + got.numel()) * v.element_size()
            bound = roofline(nbytes, flops, PEAK_FLOPS[torch.float32])
            # what the kernel reads from L1/L2: Cg channels of every valid corner
            corner_bytes = corners * Cg * v.element_size()
            print(f"dcnv3_core row {row} x{tuple(xs)} G {G} P {P} x{count}/batch {str(dtype)[6:]}: "
                  f"kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} "
                  f"library_ms {library_ms:.4f} (grid_sample, sampling only, no mask product) "
                  f"bound_ms {bound[0]:.4f} ({bound[1]}; {nbytes / 1e6:.1f} MB, {flops / 1e6:.0f} MFLOP) "
                  f"corner reads {corner_bytes / 1e6:.1f} MB x bound {kernel_ms / bound[0]:.1f} "
                  f"max_abs_err {err:.3e}")
            if dtype == torch.bfloat16:
                add_site(summary, count, kernel_ms, plain_ms, library_ms, bound, err)
    return summary


def rel_err(a: torch.Tensor, ref: torch.Tensor, keep: torch.Tensor = None) -> float:
    """Relative norm of a - ref, over the elements `keep` marks (all by
    default)."""
    a, ref = a.float(), ref.float()
    if keep is not None:
        a, ref = a * keep, ref * keep
    return (a - ref).norm().item() / max(ref.norm().item(), 1e-30)


def same_corners(offset: torch.Tensor, H: int, W: int, args) -> torch.Tensor:
    """(N, Ho, Wo, G*P*2) mask of the DCNv3 points whose kernel coordinates
    (closed form, unpadded map) and plain-version coordinates (normalised
    round trip over the padded canvas) floor to the same corners: f32
    rounds the two apart in the last bits, and a point within an ulp of an
    integer lands on either side of it, where doffset jumps (the one-sided
    derivative). The rest of the gradient is continuous there."""
    kx, ky = dcnv3_points(offset.float(), H, W, *args[:9], closed_form=True)
    px, py = dcnv3_points(offset.float(), H, W, *args[:9])
    same = (kx.floor() + args[5] == px.floor()) & (ky.floor() + args[4] == py.floor())
    return same.unsqueeze(-1).expand(*same.shape, 2).reshape(offset.shape)


def dcn_grad_bound(nbytes: int, channels: int, corners: int, points: int) -> tuple:
    """roofline() of a DCN gradient kernel: `nbytes` moved once; per channel
    of each valid corner its sample FMA, its share of the offset sums and
    the input gradient's product and atomic add (8 operations), per channel
    of each point the three products with the upstream gradient (6), in
    f32 in every dtype."""
    return roofline(nbytes, float(channels) * (8 * corners + 6 * points), PEAK_FLOPS[torch.float32])


def spill_share(plan, px: torch.Tensor, py: torch.Tensor, H: int, W: int, s: int, pad: int) -> float:
    """The share of the corners a DCN gradient kernel adds into the input
    gradient (on the map, weight not 0) that lie past their block's window
    under `plan` and go straight to global atomics; px, py (N, Ho, Wo, ...)
    the kernel's sampling points."""
    Ho, Wo = px.shape[1:3]
    rest = (1,) * (px.dim() - 3)
    oy = torch.arange(Ho, device=px.device).reshape(1, Ho, 1, *rest)
    ox = torch.arange(Wo, device=px.device).reshape(1, 1, Wo, *rest)
    y_lo = oy // plan.th * plan.th * s - pad - plan.halo
    x_lo = ox // plan.tw * plan.tw * s - pad - plan.halo
    x0, y0 = px.floor(), py.floor()
    fx, fy = px - x0, py - y0
    adds = spills = 0
    for dx, dy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        xc, yc = x0 + dx, y0 + dy
        w = (fx if dx else 1 - fx) * (fy if dy else 1 - fy)
        added = (xc >= 0) & (xc <= W - 1) & (yc >= 0) & (yc <= H - 1) & (w != 0)
        inside = (yc - y_lo >= 0) & (yc - y_lo < plan.fh) & (xc - x_lo >= 0) & (xc - x_lo < plan.fw)
        adds += added.sum().item()
        spills += (added & ~inside).sum().item()
    return spills / max(adds, 1)


def plan_text(plan) -> str:
    return (f"plan (tile {plan.th}x{plan.tw}, slice {plan.cs} of {plan.slices}, halo {plan.halo}, window "
            f"{plan.fh}x{plan.fw}, {plan.blocks} blocks, {plan.smem} B shared)")


def check_dcn_backward(v2_sites, v3_sites, gen: torch.Generator) -> tuple:
    """dcnv2_im2col_bwd and dcnv3_core_bwd against autograd of the plain
    version at every DCN site (b8, 640 px), f32 and bf16, with random
    offsets up to +-4 px (past the border) and zero offsets (the heads'
    init: integer points, the one-sided derivative); every call twice,
    both within GRAD_TOL (the input gradient is added with f32 atomics, so
    a repeat is not bitwise; the offset and mask gradients are, and must
    give the same bits); DCNv3's doffset where both
    versions' coordinates floor alike (same_corners). Timed with random
    offsets beside the plain version and autograd of grid_sample for the
    same sampling (input and grid gradients, on inputs already in its
    layout). Each line shows the launch plan and the share of corners
    that spill past its windows. Returns the bf16 summaries
    (dcnv2_im2col_bwd, dcnv3_core_bwd)."""
    sums = {"dcnv2_im2col_bwd": new_summary(), "dcnv3_core_bwd": new_summary()}

    def check(name, kernel, plain, ref, keeps, label):
        errs, calls = [], []
        for _ in range(2):
            got = kernel()
            torch.cuda.synchronize()
            errs.append([rel_err(g, r, k) for g, r, k in zip(got, ref, keeps)])
            calls.append(got)
        assert all(e <= GRAD_TOL[got[0].dtype] for row in errs for e in row), (name, label, errs)
        assert all(torch.equal(a, b) for a, b in zip(calls[0][1:], calls[1][1:])), (name, label, "not repeatable")
        plain_got = plain()
        plain_errs = [rel_err(g, r, k) for g, r, k in zip(plain_got, ref, keeps)]
        return got, max(max(row) for row in errs), plain_errs

    for row, count, xs, k, s, p in v2_sites:
        N, H, W, C = xs
        Ho, Wo, P = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1, k * k
        x32 = torch.randn(xs, device="cuda", generator=gen)
        m32 = torch.sigmoid(torch.randn((N, Ho, Wo, P), device="cuda", generator=gen))
        g32 = torch.randn((N, Ho * Wo, P * C), device="cuda", generator=gen)
        rand = ((torch.rand((2, N, Ho, Wo, P), device="cuda", generator=gen) - 0.5) * 8).unbind(0)
        for offsets, (oy32, ox32) in (("random", rand), ("zero", (torch.zeros_like(m32), torch.zeros_like(m32)))):
            kk = torch.arange(k, device="cuda")
            py = (torch.arange(Ho, device="cuda") * s - p)[None, :, None, None] + kk.repeat_interleave(k) + oy32
            px = (torch.arange(Wo, device="cuda") * s - p)[None, None, :, None] + kk.repeat(k) + ox32
            corners = valid_corners(px, py, H, W)
            for dtype in (torch.float32, torch.bfloat16):
                x, oy, ox, m, g = (t.to(dtype).contiguous() for t in (x32, oy32, ox32, m32, g32))
                plan = _v2_bwd_plan(N, C, Ho, Wo, k, s, x.element_size())
                spill = spill_share(plan, px, py, H, W, s, p)
                ref = dcnv2_im2col_backward_reference(x.float(), oy.float(), ox.float(), m.float(), g.float(), k, s, p)
                kernel = lambda: dcnv2_im2col_bwd(x, oy, ox, m, g, k, s, p)  # noqa: E731
                plain = lambda: dcnv2_im2col_backward_reference(x, oy, ox, m, g, k, s, p)  # noqa: E731
                got, err, plain_errs = check("dcnv2_im2col_bwd", kernel, plain, ref, (None,) * 4,
                                             f"row {row} {offsets}")
                if offsets == "zero":
                    assert all(r.abs().max() > 0 for r in ref[1:3]), "zero offsets: no offset gradient"
                abs_err = max((a.float() - b).abs().max().item() for a, b in zip(got, ref))
                kernel_ms = time_ms(kernel)
                line = (f"dcnv2_im2col_bwd row {row} x{tuple(xs)} dcols {tuple(g.shape)} x{count}/step "
                        f"{str(dtype)[6:]} {offsets} offsets {plan_text(plan)} spill {spill:.4f}: "
                        f"kernel_ms {kernel_ms:.4f}")
                if offsets == "random":
                    xin = x.permute(0, 3, 1, 2).contiguous()
                    grid = grid_of(px, py, H, W, dtype).reshape(N, Ho * Wo, P, 2)
                    gout = g.reshape(N, Ho * Wo, P, C).permute(0, 3, 1, 2).contiguous()
                    library = lambda: torch.ops.aten.grid_sampler_2d_backward(  # noqa: E731
                        gout, xin, grid, 0, 0, False, [True, True])
                    plain_ms, library_ms = time_ms(plain), time_ms(library)
                    nbytes = (2 * x.numel() + 6 * oy.numel() + g.numel()) * x.element_size()
                    bound = dcn_grad_bound(nbytes, C, corners, N * Ho * Wo * P)
                    line += (f" plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} (grid_sample's backward, "
                             f"sampling only) bound_ms {bound[0]:.4f} ({bound[1]}; {nbytes / 1e6:.1f} MB) x bound "
                             f"{kernel_ms / bound[0]:.1f}")
                    if dtype == torch.bfloat16:
                        add_site(sums["dcnv2_im2col_bwd"], count, kernel_ms, plain_ms, library_ms, bound, abs_err)
                print(line + f"; {corners * C / 1e6:.1f} M f32 adds at most; rel norm err (dx, doffset_y, "
                      f"doffset_x, dmask) max {err:.2e}, plain {', '.join(f'{e:.1e}' for e in plain_errs)}; "
                      f"max_abs_err {abs_err:.3e}")
    for site in v3_sites:
        row, count, xs = site[:3]
        d = dcnv3_site(site, gen)
        N, H, W, G, Cg, Ho, Wo, P = d["shape"]
        args = d["args"]
        g32 = torch.randn((N, Ho, Wo, G * Cg), device="cuda", generator=gen)
        for offsets, o32, px, py in (("random", d["o32"], d["px"], d["py"]),
                                     ("zero", torch.zeros_like(d["o32"]), d["bx"].expand_as(d["px"]),
                                      d["by"].expand_as(d["py"]))):
            corners = valid_corners(px, py, H, W)
            for dtype in (torch.float32, torch.bfloat16):
                v, o, m, g = (t.to(dtype).contiguous() for t in (d["v32"], o32, d["m32"], g32))
                plan = _v3_bwd_plan(N, G, Cg, Ho, Wo, *args[:4], *args[6:8], v.element_size())
                spill = spill_share(plan, px, py, H, W, args[2], args[4])
                ref = dcnv3_core_backward_reference(v.float(), o.float(), m.float(), g.float(), *args)
                keep = same_corners(o, H, W, args)
                kernel = lambda: dcnv3_core_bwd(v, o, m, g, *args)  # noqa: E731
                plain = lambda: dcnv3_core_backward_reference(v, o, m, g, *args)  # noqa: E731
                got, err, plain_errs = check("dcnv3_core_bwd", kernel, plain, ref, (None, keep, None),
                                             f"row {row} {offsets}")
                abs_err = max(((a.float() - b) * (kk if kk is not None else 1)).abs().max().item()
                              for a, b, kk in zip(got, ref, (None, keep, None)))
                kernel_ms = time_ms(kernel)
                line = (f"dcnv3_core_bwd row {row} x{tuple(xs)} G {G} P {P} x{count}/step {str(dtype)[6:]} "
                        f"{offsets} offsets {plan_text(plan)} spill {spill:.4f}: kernel_ms {kernel_ms:.4f}")
                if offsets == "random":
                    vin = v.reshape(N, H, W, G, Cg).permute(0, 3, 4, 1, 2).reshape(N * G, Cg, H, W).contiguous()
                    grid = grid_of(px, py, H, W, dtype).permute(0, 3, 1, 2, 4, 5).reshape(N * G, Ho * Wo, P, 2)
                    gout = g.reshape(N, Ho * Wo, G, 1, Cg).expand(N, Ho * Wo, G, P, Cg).permute(0, 2, 4, 1, 3).reshape(
                        N * G, Cg, Ho * Wo, P).contiguous()
                    library = lambda: torch.ops.aten.grid_sampler_2d_backward(  # noqa: E731
                        gout, vin, grid, 0, 0, False, [True, True])
                    plain_ms, library_ms = time_ms(plain), time_ms(library)
                    nbytes = (2 * (v.numel() + o.numel() + m.numel()) + g.numel()) * v.element_size()
                    bound = dcn_grad_bound(nbytes, Cg, corners, N * Ho * Wo * G * P)
                    line += (f" plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} (grid_sample's backward, "
                             f"sampling only) bound_ms {bound[0]:.4f} ({bound[1]}; {nbytes / 1e6:.1f} MB) x bound "
                             f"{kernel_ms / bound[0]:.1f}")
                    if dtype == torch.bfloat16:
                        add_site(sums["dcnv3_core_bwd"], count, kernel_ms, plain_ms, library_ms, bound, abs_err)
                print(line + f"; {corners * Cg / 1e6:.1f} M f32 adds at most; doffset compared at "
                      f"{keep.float().mean().item():.6f} of the points; rel norm err (dvalue, doffset, dmask) max "
                      f"{err:.2e}, plain {', '.join(f'{e:.1e}' for e in plain_errs)}; max_abs_err {abs_err:.3e}")
    return sums["dcnv2_im2col_bwd"], sums["dcnv3_core_bwd"]


# ---------------------------------------------------------------------------
# serving and parity
# ---------------------------------------------------------------------------


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def only(**counts) -> dict:
    """Every kernel's expected count: those named, 0 for the rest."""
    return {k.__name__: counts.get(k.__name__, 0) for k in KERNELS}


def serve(gpu: str, cfg_name: str) -> dict:
    """Serve N_REQUESTS batches with the YAML's nc at SERVE_CONF, every
    image answered with at least one detection; returns this path's launch
    counts."""
    runner = Runner(cfg_name, dtype=torch.bfloat16, imgsz=IMGSZ, device="cuda", seed=0)
    randomize_offset_heads(runner.model, seed=0)
    cfg = runner.meta.yaml
    width = (cfg["width_multiple"], cfg["depth_multiple"])
    assert width == FAMILY_SERVED.get(cfg_name, (1.0, 1.0)), cfg
    conf = SERVE_CONF.get(cfg_name, 0.25)
    n_params = sum(p.numel() for p in runner.model.parameters())
    per_batch = PER_BATCH.get(cfg_name, {})
    # the graph's own count of kernel sites agrees with the expected launches
    sites = {"odconv_s2": len(odconv_sites(runner.meta, BATCH, IMGSZ)),
             "dcnv2_im2col": sum(isinstance(m, DCNv2) for m in runner.model.modules()),
             "dcnv3_core": sum(isinstance(m, DCNv3) for m in runner.model.modules())}
    assert sites == {name: per_batch.get(name, 0) for name in sites}, (sites, per_batch)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8) for _ in range(N_REQUESTS + 1)]
    runner(batches[0], conf_thres=conf)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    reset_counts()
    lat = []
    for images in batches[1:]:
        t0 = time.perf_counter()
        out = runner(images, conf_thres=conf)  # ends in a device->host copy of the detections
        lat.append(time.perf_counter() - t0)
        assert out.shape == (BATCH, 300, 6) and np.isfinite(out).all(), out.shape
        valid = out[..., 4] > 0
        assert (out[~valid] == 0).all()
        assert valid.any(1).all(), f"{cfg_name}: an image without detections at conf {conf}: no NMS work"
    launches = launch_counts()
    assert launches == {name: per_batch.get(name, 0) * N_REQUESTS for name in launches}, launches
    med = statistics.median(lat)
    RECORD[f"serve {cfg_name}"] = med
    per = ", ".join(f"{name} {n // N_REQUESTS}/batch" for name, n in launches.items() if n)
    print(f"serving {cfg_name} published width/depth {width[0]}/{width[1]} ({n_params / 1e6:.2f} M params, "
          f"nc {runner.meta.nc}) 640 px bf16 conf {conf:g} "
          f"b{BATCH}, {N_REQUESTS} requests on {gpu}: latency median {med * 1e3:.2f} ms/batch "
          f"(min {min(lat) * 1e3:.2f}, max {max(lat) * 1e3:.2f}), {BATCH / med:.1f} img/s, "
          f"detections/img {valid.sum(1).mean():.1f}, launches {per or 'none'}")

    # the batch split by layer: upload + model, then postprocess (NMS)
    fwd, post = [], []
    for images in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds = runner.forward(images)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fused_postprocess(preds, runner.meta.anchors_px, runner.meta.strides, conf_thres=conf).cpu()
        fwd.append(t1 - t0)
        post.append(time.perf_counter() - t1)
    print(f"split {cfg_name}: upload+model median {statistics.median(fwd) * 1e3:.2f} ms/batch, "
          f"postprocess median {statistics.median(post) * 1e3:.2f} ms/batch")

    # where the device time goes, one batch under the profiler
    OUT.mkdir(exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        runner(batches[1], conf_thres=conf)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ours = {name: sum(e.self_device_time_total for e in kernels if name in e.key) / 1e3 for name in per_batch}
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    path = OUT / f"chip_smoke_profile_{cfg_name.replace('/', '_')}.txt"
    path.write_text(f"{gpu}\n{table}\n")
    shares = "".join(f", {name} kernels {ms:.3f} ms ({100 * ms / max(busy_ms, 1e-9):.1f}% of device time)"
                     for name, ms in ours.items())
    print(f"profile {cfg_name} (one batch, profiler on): wall {wall_ms:.2f} ms, device kernels {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% busy){shares}; table in {path}")
    return launches


def sweep(gpu: str) -> None:
    """Every SWEEP config builds at its published width with its YAML's nc
    (random weights from seed 0) and answers one b8 bf16 batch: (B, 300, 6)
    rows, all finite, and no kernel launched."""
    t_phase = time.perf_counter()
    images = np.random.default_rng(0).integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    for cfg_name in SWEEP:
        t0 = time.perf_counter()
        runner = Runner(cfg_name, dtype=torch.bfloat16, imgsz=IMGSZ, device="cuda", seed=0)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reset_counts()
        out = runner(images)
        t2 = time.perf_counter()
        assert out.shape == (BATCH, 300, 6) and np.isfinite(out).all(), (cfg_name, out.shape)
        assert not any(launch_counts().values()), (cfg_name, launch_counts())
        meta = runner.meta
        print(f"sweep {cfg_name}: {sum(p.numel() for p in runner.model.parameters()) / 1e6:.2f} M params, "
              f"{meta.head_type} nc {meta.nc} na {meta.na} strides {[int(s) for s in meta.strides]}; build "
              f"{t1 - t0:.2f} s, first b{BATCH} batch {(t2 - t1) * 1e3:.1f} ms, "
              f"{int((out[..., 4] > 0).sum())} rows, every kernel count 0")
        del runner
        torch.cuda.empty_cache()
    print(f"sweep on {gpu}: {len(SWEEP)} configs in {time.perf_counter() - t_phase:.1f} s")


def parity(cfg_name: str) -> None:
    """The model at its published width with its YAML's nc, in f32 through
    the kernels and through their plain versions, on one batch of 2, each
    held against the plain version in f64 (DCN offset/mask heads
    randomised).

    A fixed atol cannot hold here: head outputs reach ~170 and 36 random
    layers amplify f32 rounding, so the plain f32 model itself misses f64
    by ~1e-2. The kernels
    pass when their f32 model is no further from f64 than twice the plain
    f32 model is. A config with no kernel site is its own plain version:
    its one f32 run's distance from f64 is printed, and the rule has
    nothing to hold."""
    runner = Runner(cfg_name, dtype=torch.float32, imgsz=IMGSZ, device="cuda", seed=0)
    randomize_offset_heads(runner.model, seed=0)
    images = np.random.default_rng(1).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    before = launch_counts()
    raw = runner.forward(images)
    per_forward = {name: n - before[name] for name, n in launch_counts().items()}
    assert per_forward == {name: PER_BATCH.get(cfg_name, {}).get(name, 0) for name in per_forward}, per_forward
    with plain_version():
        ref = runner.forward(images) if any(per_forward.values()) else raw
        with torch.inference_mode():
            x64 = torch.from_numpy(images).cuda().permute(0, 3, 1, 2).double() / 255.0
            ref64 = copy.deepcopy(runner.model).double()(x64)
    assert launch_counts() == {name: before[name] + per_forward[name] for name in before}
    for i, (a, b, c) in enumerate(zip(raw, ref, ref64)):
        assert a.shape == b.shape == c.shape and torch.isfinite(a).all()
        k_err = (a.double() - c).abs().max().item()
        p_err = (b.double() - c).abs().max().item()
        diff = (a - b).abs().max().item()
        errs = (f"kernel-vs-plain {diff:.3e}, vs f64: kernel {k_err:.3e} plain {p_err:.3e}" if b is not a
                else f"no kernel site, f32 vs f64 {k_err:.3e}")
        print(f"parity {cfg_name} level {i}: max |out| {c.abs().max().item():.3e}, {errs}")
        assert k_err <= 2 * p_err + 1e-6, (cfg_name, i, k_err, p_err)


# ---------------------------------------------------------------------------
# eval
# ---------------------------------------------------------------------------


def synthetic_shapes(rng: np.random.Generator, h: int, w: int):
    """Noise with 2-7 bright rectangles and discs drawn by numpy masks, and
    their boxes: (n, 5) [cls, x1, y1, x2, y2] pixels, class 0 a rectangle,
    class 1 a disc (the mask's bounding box, x2 and y2 exclusive)."""
    im = (rng.integers(0, 80, (h, w, 3)) + rng.integers(0, 40)).astype(np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    boxes = []
    for _ in range(rng.integers(2, 8)):
        s = int(rng.integers(20, 120))
        cx, cy = int(rng.integers(s, w - s)), int(rng.integers(s, h - s))
        rect = rng.random() < 0.5
        if rect:
            mask = (np.abs(xx - cx) < s // 2) & (np.abs(yy - cy) < s // 3)
        else:
            mask = (xx - cx) ** 2 + (yy - cy) ** 2 < (s // 2) ** 2
        im[mask] = rng.integers(120, 256, 3)
        ys, xs = np.nonzero(mask)
        boxes.append((0 if rect else 1, xs.min(), ys.min(), xs.max() + 1, ys.max() + 1))
    return im, np.array(boxes, np.float32)


def synthetic_image(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """synthetic_shapes' image alone."""
    return synthetic_shapes(rng, h, w)[0]


@torch.no_grad()
def temper_head(model: torch.nn.Module, factor: float) -> None:
    """Scale the weights of the head's output convs (each level's box/obj
    conv b3 and class conv c3), so that random logits stay below sigmoid's
    saturation and the scores rank the boxes."""
    for level in model.model[-1].m:
        level.b3.weight.mul_(factor)
        level.c3.weight.mul_(factor)


def self_label(runner: Runner, root: Path) -> int:
    """Label every image of root/images with the top EVAL_TOP single-label
    detections (conf > 0.25) of `runner` under plain_version(), mapped back
    to original-image normalized xywh. Returns the number of labels."""
    n = 0
    loader = DataLoader(DetectionDataset(str(root / "images"), img_size=IMGSZ), BATCH)
    with plain_version():
        for images, _, paths, shapes in loader:
            out = runner(images, conf_thres=0.25)
            for det, path, ((h0, w0), ratio_pad) in zip(out, paths, shapes):
                label = root / "labels" / (Path(path).stem + ".txt")
                if label.exists():  # the wrapped tail of the last batch
                    continue
                det = det[det[:, 4] > 0][:EVAL_TOP]
                xywhn = xyxy2xywhn(scale_coords(images.shape[1:3], det[:, :4], (h0, w0), ratio_pad), w=w0, h=h0)
                rows = [f"{int(c)} " + " ".join(f"{v:.6f}" for v in b) for c, b in zip(det[:, 5], xywhn)
                        if (b[2:] > 0).all()]
                label.write_text("".join(r + "\n" for r in rows))
                n += len(rows)
    return n


def eval_split(name: str, runner: Runner, loader: DataLoader) -> None:
    """The eval batches split by layer: upload + model, then decode, NMS
    and the copy to the host."""
    fwd, post = [], []
    for images, *_ in loader:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds = runner.forward(images)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        non_max_suppression(decode(preds, runner.meta.anchors_px, runner.meta.strides), **EVAL_NMS).cpu()
        fwd.append(t1 - t0)
        post.append(time.perf_counter() - t1)
    print(f"eval split {name}: upload+model median {statistics.median(fwd) * 1e3:.2f} ms/batch, decode+NMS "
          f"median {statistics.median(post) * 1e3:.2f} ms/batch ({len(fwd)} batches)")


def evaluate(gpu: str, cfg_name: str = "yolo-somi", offsets: str = "random", workdir: Path = None) -> tuple:
    """val.run of the full-width `cfg_name` on a set it labels itself: f32
    through the kernels against f32 under plain_version(), then bf16
    through the kernels, timed. DCN offset heads are randomised, or left
    at their zero init with offsets="zero". The set is written under
    `workdir` when one is given (phase 12 evaluates on it again), else in a
    temporary directory. Returns the bf16 run's results."""
    t_phase = time.perf_counter()
    title = cfg_name if offsets == "random" else f"{cfg_name} ({offsets} offsets)"
    with contextlib.nullcontext(str(workdir)) if workdir else tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "ds"  # the loader's label cache lands in tmp, beside ds
        (root / "images").mkdir(parents=True)
        (root / "labels").mkdir()
        rng = np.random.default_rng(0)
        for i in range(EVAL_IMAGES):
            assert cv2.imwrite(str(root / "images" / f"im{i:03d}.jpg"), synthetic_image(rng, 480, 640))
        data = root / "data.yaml"
        data.write_text(yaml.safe_dump({"path": str(root), "train": "images", "val": "images", "nc": 10,
                                        "names": [f"class{i}" for i in range(10)]}))

        runner = Runner(cfg_name, nc=10, dtype=torch.float32, imgsz=IMGSZ, device="cuda", seed=0)
        if offsets == "random":
            randomize_offset_heads(runner.model, seed=0)
        with plain_version():  # why the head is tempered: its scores before
            images = next(iter(DataLoader(DetectionDataset(str(root / "images"), img_size=IMGSZ), BATCH)))[0]
            conf = runner(images, conf_thres=0.25)[..., 4]
        print(f"eval {title}: untempered head, {(conf == 1.0).sum() / BATCH:.1f} of {(conf > 0).sum() / BATCH:.1f} "
              f"detections (conf > 0.25) per image have conf exactly 1.0")
        temper_head(runner.model, HEAD_TEMPER)
        n_labels = self_label(runner, root)
        loader = DataLoader(DetectionDataset(str(root / "images"), img_size=IMGSZ), BATCH)
        kw = dict(data=str(data), batch_size=BATCH, imgsz=IMGSZ, project=str(Path(tmp) / "runs"), exist_ok=True,
                  dataloader=loader)

        def run(name: str, r: Runner):
            t0 = time.perf_counter()
            results, _, speed = val.run(runner=r, name=name, **kw)
            wall = time.perf_counter() - t0
            seen = json.loads((Path(tmp) / "runs" / name / "metrics.json").read_text())["images"]
            print(f"eval {title} {name}: P {results[0]:.5f} R {results[1]:.5f} mAP@.5 {results[2]:.5f} "
                  f"mAP@.5:.95 {results[3]:.5f} images {seen}; Speed {speed[0]:.2f} ms pre, {speed[1]:.2f} ms "
                  f"inference+NMS, {speed[2]:.2f} ms post per image; {seen / wall:.1f} img/s ({wall:.2f} s)")
            assert seen == EVAL_IMAGES, seen
            return results

        reset_counts()
        kernels = run("f32-kernels", runner)
        launches = launch_counts()
        reset_counts()
        with plain_version():
            plain = run("f32-plain", runner)
        plain_launches = launch_counts()
        print(f"eval {title} launches: kernels {launches}, plain_version() {plain_launches}; {n_labels} labels")
        n_batches = -(-EVAL_IMAGES // BATCH)
        assert launches == only(**{k: n * n_batches for k, n in PER_BATCH[cfg_name].items()}), launches
        assert not any(plain_launches.values()), plain_launches
        assert plain[2] > 0.5, f"plain mAP@.5 {plain[2]}: the self-labelled check would be vacuous"
        assert abs(kernels[2] - plain[2]) <= 0.01, (kernels[2], plain[2])
        assert abs(kernels[3] - plain[3]) <= 0.02, (kernels[3], plain[3])

        eval_split(f"{title} f32", runner, loader)

        del runner
        runner = Runner(cfg_name, nc=10, dtype=torch.bfloat16, imgsz=IMGSZ, device="cuda", seed=0)
        if offsets == "random":
            randomize_offset_heads(runner.model, seed=0)
        temper_head(runner.model, HEAD_TEMPER)
        runner(next(iter(loader))[0], **EVAL_NMS)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        bf16 = run("bf16-kernels", runner)
        assert launch_counts() == launches, launch_counts()
        reset_counts()
        with plain_version():  # what bf16 itself costs against the f32 labels
            run("bf16-plain", runner)
        assert not any(launch_counts().values()), launch_counts()
        eval_split(f"{title} bf16", runner, loader)
    print(f"eval {title} on {gpu}: phase {time.perf_counter() - t_phase:.1f} s")
    return bf16


# ---------------------------------------------------------------------------
# checkpoints and entry points
# ---------------------------------------------------------------------------


def save_model(path: Path, cfg_name: str, seed: int, anchor_scale: float = 1.0, dcn: bool = False):
    """Build `cfg_name` at full width (nc 10, f32, weights from `seed`; DCN
    offset heads randomised when `dcn`) and write it as a weights file with
    its anchors times `anchor_scale`. Returns (anchors, seconds to build,
    seconds to export and write)."""
    t0 = time.perf_counter()
    model, meta = build_model(load_model_cfg(find_config(cfg_name)), nc=10, device="cuda", dtype=torch.float32,
                              seed=seed)
    if dcn:
        randomize_offset_heads(model, seed=seed)
    t1 = time.perf_counter()
    anchors = (meta.anchors_px * anchor_scale).astype(np.float32)
    save_variables(path, export_jax_variables(model), anchors=anchors)
    return anchors, t1 - t0, time.perf_counter() - t1


def drop_twins(rows: np.ndarray):
    """(B, max_det, 6) rows with each valid row that repeats an earlier one
    of its image removed (the rest moved up, zeros after), and the count
    removed. An ensemble of twins pools every box twice; the NMS drops the
    second copy for its IoU of 1 with the first, except for a box of zero
    area, whose IoU with its twin is 0."""
    out, n = np.zeros_like(rows), 0
    for b, r in enumerate(rows):
        r = r[r[:, 4] > 0]
        keep = np.sort(np.unique(r, axis=0, return_index=True)[1])
        out[b, :len(keep)] = r[keep]
        n += len(r) - len(keep)
    return out, n


class Lines(logging.Handler):
    """Collects the package logger's lines (detect's per-image and Speed lines)."""

    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def post(url: str, body: bytes, ctype: str = None):
    """(records, seconds) of one request."""
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype} if ctype else {}, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=120) as r:
        records = json.loads(r.read())
    return records, time.perf_counter() - t0


def multipart(payload: bytes, boundary: bytes = b"somi-smoke-boundary"):
    body = (b"--" + boundary + b'\r\nContent-Disposition: form-data; name="image"; filename="frame.jpg"\r\n'
            + b"Content-Type: image/jpeg\r\n\r\n" + payload + b"\r\n--" + boundary + b"--\r\n")
    return body, "multipart/form-data; boundary=" + boundary.decode()


def entry_points(gpu: str) -> None:
    """Phase 7: weights files, Runner(weights=...), detect, the ensemble and
    the REST server, at full width."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # -- the flagship's round trip through a weights file ---------------
        f32_path, bf16_path = tmp / "somi-f32.msgpack", tmp / "somi-bf16.msgpack"
        anchors, t_build, t_save = save_model(f32_path, "yolo-somi", seed=0, anchor_scale=ANCHOR_SCALE)
        t0 = time.perf_counter()
        strip_checkpoint(f32_path, bf16_path)
        t_strip = time.perf_counter() - t0
        t0 = time.perf_counter()
        blob = f32_path.read_bytes()
        t1 = time.perf_counter()
        msgpack_restore(blob)
        t2 = time.perf_counter()
        del blob
        runner = Runner("yolo-somi", str(f32_path), dtype=torch.bfloat16, imgsz=IMGSZ, device="cuda")
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        print(f"checkpoint on {gpu}: yolo-somi f32 file {f32_path.stat().st_size / 1e6:.1f} MB (build {t_build:.2f} s, "
              f"export + write {t_save:.2f} s), bf16 strip {bf16_path.stat().st_size / 1e6:.1f} MB ({t_strip:.2f} s); "
              f"load: read {t1 - t0:.2f} s, decode {t2 - t1:.2f} s, Runner(weights=...) whole {t3 - t2:.2f} s "
              f"(read, decode, build, copy to the device)")
        assert runner.meta.nc == 10 and np.array_equal(runner.meta.anchors_px, anchors), runner.meta.anchors_px
        cfg = dict(load_model_cfg(find_config("yolo-somi")))
        cfg["anchors"] = anchors.reshape(len(anchors), -1).tolist()
        anchored_cfg = tmp / "yolo-somi-anchors.yaml"
        anchored_cfg.write_text(yaml.safe_dump(cfg))
        direct = Runner(str(anchored_cfg), nc=10, dtype=torch.bfloat16, imgsz=IMGSZ, device="cuda", seed=0)
        batch = np.random.default_rng(2).integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8)
        got = runner(batch)
        assert got.shape == (BATCH, 300, 6) and np.isfinite(got).all()
        assert np.array_equal(got, direct(batch)), "Runner(weights=...) and the seed-0 Runner disagree"
        with torch.device("meta"):  # the config's anchors; nothing is allocated
            config_meta = parse_model(load_model_cfg(find_config("yolo-somi")))[1]
        config_anchors = fused_postprocess(direct.forward(batch), config_meta.anchors_px,
                                           direct.meta.strides).cpu().numpy()
        n_diff = int((np.abs(config_anchors - got).max(-1) > 0).sum())
        assert n_diff > 0, "the config's anchors give the same rows: the override check is vacuous"
        stripped = Runner("yolo-somi", str(bf16_path), dtype=torch.bfloat16, imgsz=IMGSZ, device="cuda")
        state = stripped.model.state_dict()
        for key, value in runner.model.state_dict().items():
            assert torch.equal(state[key], value), key
        print(f"checkpoint: anchors from the file; b{BATCH} rows bitwise equal to the seed-0 Runner with those "
              f"anchors, {n_diff} of {BATCH * 300} rows differ under the config's anchors; the bf16 copy loads "
              f"{len(state)} tensors bitwise equal")
        del direct, stripped, state

        # -- detect on drone frames and VGA images --------------------------
        src = tmp / "detect-src"
        src.mkdir()
        rng = np.random.default_rng(0)
        i = 0
        for count, h, w in DETECT_IMAGES:
            for _ in range(count):
                assert cv2.imwrite(str(src / f"im{i:02d}_{w}x{h}.jpg"), synthetic_image(rng, h, w))
                i += 1
        lines = Lines()
        LOGGER.addHandler(lines)
        reset_counts()
        t0 = time.perf_counter()
        try:
            run_dir = detect.run(weights=str(f32_path), cfg="yolo-somi", source=str(src), imgsz=IMGSZ, save_txt=True,
                                 save_conf=True, project=str(tmp / "runs"), name="detect", device="cuda")
        finally:
            LOGGER.removeHandler(lines)
        wall = time.perf_counter() - t0
        launches = launch_counts()
        assert launches == only(odconv_s2=4 * i), launches
        n_rows = 0
        for path, img, im0, _ in LoadImages(str(src), img_size=IMGSZ, stride=runner.stride):
            det = runner(img[None], conf_thres=0.4, iou_thres=0.2)[0]
            det = det[det[:, 4] > 0]
            det[:, :4] = scale_coords(img.shape[:2], det[:, :4], im0.shape[:2])
            want = [detect.label_line(int(c), xyxy, im0.shape, conf) for *xyxy, conf, c in det]
            label = run_dir / "labels" / f"{Path(path).stem}.txt"
            have = label.read_text().splitlines() if label.exists() else []
            assert have == want, (path, len(have), len(want))
            n_rows += len(want)
        speed = next(line for line in lines.lines if line.startswith("Speed"))
        per_image = [float(line.rsplit("(", 1)[1][:-3]) for line in lines.lines if line.endswith("ms)")]
        assert len(per_image) == i, lines.lines
        print(f"detect on {gpu}: {i} images ({', '.join(f'{c} at {w}x{h}' for c, h, w in DETECT_IMAGES)}), "
              f"{i / wall:.1f} img/s over the whole run ({wall:.2f} s, model build included), odconv_s2 "
              f"{launches['odconv_s2']} launches; {n_rows} label rows equal to the Runner's; inference+NMS per "
              f"image: first (cold) {per_image[0]:.1f} ms, median of the rest {statistics.median(per_image[1:]):.1f} "
              f"ms; detect says: {speed}")

        # -- the ensemble ---------------------------------------------------
        b_path = tmp / "somi-seed1.msgpack"
        save_model(b_path, "yolo-somi", seed=1, anchor_scale=ANCHOR_SCALE)
        temper_head(runner.model, HEAD_TEMPER)
        twins = attempt_load([str(f32_path), str(f32_path)], "yolo-somi", device="cuda")
        assert isinstance(twins, EnsembleRunner)
        for m in twins.members:
            temper_head(m.model, HEAD_TEMPER)
        with torch.inference_mode():
            rows = runner.decode(runner.forward(batch))
            scores = (rows[..., 5:] * rows[..., 4:5]).amax(-1)
            candidates = {t: int((scores > t).sum(1).max()) for t in (0.05, ENSEMBLE_CONF, 0.25)}
        print(f"ensemble: most candidates of an image above conf 0.05 / {ENSEMBLE_CONF} / 0.25: "
              f"{' / '.join(str(n) for n in candidates.values())} (head tempered by {HEAD_TEMPER})")
        assert candidates[ENSEMBLE_CONF] < 4096 // 2, "a doubled pool would overflow max_nms"
        ens_rows = twins(batch, conf_thres=ENSEMBLE_CONF)
        single_rows = runner(batch, conf_thres=ENSEMBLE_CONF, exact=True)
        assert (ens_rows[..., 4] > 0).any(), "no rows: the ensemble check would be vacuous"
        ens_rows, n_twins = drop_twins(ens_rows)
        assert np.array_equal(ens_rows, single_rows), "the ensemble of twins disagrees with the single Runner"
        del twins
        pair = attempt_load([str(f32_path), str(b_path)], "yolo-somi", device="cuda")
        pair(batch)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out = pair(batch)
        pair_ms = (time.perf_counter() - t0) * 1e3
        launches = launch_counts()
        assert launches == only(odconv_s2=8), launches
        assert np.isfinite(out).all()
        print(f"ensemble on {gpu}: [a, a] equals Runner(a) on b{BATCH} at conf {ENSEMBLE_CONF} "
              f"({int((ens_rows[..., 4] > 0).sum())} rows; {n_twins} twins of zero-area boxes dropped); "
              f"[a, seed 1] one b{BATCH} batch {pair_ms:.2f} ms, odconv_s2 {launches['odconv_s2']} launches")
        del pair, runner

        # -- yolo-somi-dcn from a checkpoint, through the REST server -------
        dcn_path = tmp / "somi-dcn.msgpack"
        save_model(dcn_path, "yolo-somi-dcn", seed=0, dcn=True)
        model = hubconf.yolo_somi_dcn(weights=str(dcn_path))
        assert model.runner.meta.nc == 10 and model.runner.device.type == "cuda"
        frames = sorted(src.iterdir())
        payloads = [p.read_bytes() for p in (frames[0], frames[1], frames[-2], frames[-1])][:N_POSTS]
        images = [cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR) for b in payloads]
        model(images[0])  # warm-up: cuDNN plans for b1
        server = DetectionServer(("127.0.0.1", 0), model)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        url = f"http://127.0.0.1:{server.server_address[1]}/v1/object-detection/yolo-somi-dcn"
        try:
            torch.cuda.synchronize()
            reset_counts()
            answers, lat = [], []
            for payload in payloads:
                for body, ctype in ((payload, None), multipart(payload)):
                    records, secs = post(url, body, ctype)
                    answers.append(records)
                    lat.append(secs)
            launches = launch_counts()
        finally:
            server.shutdown()
            server.close()
            thread.join(timeout=30)
        per = {"odconv_s2": 4, "dcnv2_im2col": 9, "dcnv3_core": 1}
        assert launches == only(**{k: n * 2 * len(payloads) for k, n in per.items()}), launches
        for j, img in enumerate(images):
            direct_records = json.loads(json.dumps(model(img).records()[0]))
            assert answers[2 * j] == answers[2 * j + 1] == direct_records, j
        n_records = sum(len(a) for a in answers)
        print(f"serve on {gpu}: yolo-somi-dcn from a weights file, {len(answers)} requests "
              f"({len(payloads)} raw, {len(payloads)} multipart; 1920x1080 and 640x480 JPEGs), latency median "
              f"{statistics.median(lat) * 1e3:.2f} ms (min {min(lat) * 1e3:.2f}, max {max(lat) * 1e3:.2f}), "
              f"{n_records} records equal to AutoShape's; launches per forward "
              f"{', '.join(f'{k} {n // len(answers)}' for k, n in launches.items())}")
        del model

        # -- the yolov5 hub loaders, and yolo-somi-t from a weights file ----
        paths = [str(f) for f in frames]
        for loader in (hubconf.yolov5s, hubconf.yolov5l):
            model = loader(device="cuda", conf=HUB_CONF)
            assert model.runner.meta.nc == 80 and model.runner.meta.head_type == "Detect"
            model(paths[:2])  # warm-up
            torch.cuda.synchronize()
            reset_counts()
            t0 = time.perf_counter()
            results = model(paths)
            secs = time.perf_counter() - t0
            assert not any(launch_counts().values()), launch_counts()
            assert len(results.pred) == len(paths)
            for det, im in zip(results.pred, results.ims):
                h, w = im.shape[:2]
                assert np.isfinite(det).all() and (det[:, [0, 2]] >= 0).all() and (det[:, [0, 2]] <= w).all()
                assert (det[:, [1, 3]] >= 0).all() and (det[:, [1, 3]] <= h).all()
            n_rows = sum(len(det) for det in results.pred)
            assert n_rows > 0, "no rows: the hub check would be vacuous"
            print(f"hubconf.{loader.__name__} on {gpu}: nc 80, {len(paths)} JPEGs in one AutoShape call "
                  f"{secs * 1e3:.1f} ms, {n_rows} rows at conf {HUB_CONF} (random weights), all finite and inside "
                  f"their images; no kernel launched")
            del model
        t_path = tmp / "somi-t.msgpack"
        save_model(t_path, "yolo-somi-t", seed=0)
        from_file = Runner("yolo-somi-t", str(t_path), dtype=torch.bfloat16, imgsz=IMGSZ, device="cuda")
        direct = Runner("yolo-somi-t", nc=10, dtype=torch.bfloat16, imgsz=IMGSZ, device="cuda", seed=0)
        state = from_file.model.state_dict()
        for key, value in direct.model.state_dict().items():
            assert torch.equal(state[key], value), key
        reset_counts()
        got = from_file(batch)
        assert np.array_equal(got, direct(batch)) and np.isfinite(got).all()
        assert not any(launch_counts().values()), launch_counts()
        print(f"checkpoint: yolo-somi-t (coupled Detect) through export_jax_variables loads {len(state)} tensors "
              f"bitwise equal to the seed-0 model; b{BATCH} rows bitwise equal; no kernel launched")
    print(f"checkpoints and entry points on {gpu}: phase {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def check_backward(sites, gen: torch.Generator, cfg_name: str = "yolo-somi") -> tuple:
    """odconv_s2_dx and odconv_s2_dwmix against autograd of
    odconv_s2_reference at every ODConv site of `cfg_name` (b8, 640 px), f32
    and bf16,
    with a bitwise repeat; timed beside the plain version (autograd of the
    grouped conv for that gradient alone), cuDNN's grouped-conv backward on
    inputs already in its layout, and the copy that makes a strided dy
    contiguous. Returns the bf16 summaries (dx, dwmix)."""
    sums = {"dx": new_summary(), "dwmix": new_summary()}
    for row, xs, ws in sites:
        B, H, W, C = xs
        cout = ws[-1]
        x32 = torch.randn(xs, device="cuda", generator=gen)
        w32 = torch.randn(ws, device="cuda", generator=gen) * (2.0 / (9 * C)) ** 0.5
        dy32 = torch.randn((B, H // 2, W // 2, cout), device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            x, w, dy = x32.to(dtype), w32.to(dtype), dy32.to(dtype)
            got = {"dx": odconv_s2_dx(dy, w, H, W), "dwmix": odconv_s2_dwmix(x, dy)}
            torch.cuda.synchronize()
            ref = dict(zip(("dx", "dwmix"), odconv_s2_backward_reference(x.float(), w.float(), dy.float())))
            assert torch.equal(odconv_s2_dx(dy, w, H, W), got["dx"]), f"row {row}: two dx calls disagree"
            assert torch.equal(odconv_s2_dwmix(x, dy), got["dwmix"]), f"row {row}: two dwmix calls disagree"
            # the library call alone, on inputs already in its layout: the grouped conv's backward
            gy = dy.permute(0, 3, 1, 2).reshape(1, B * cout, H // 2, W // 2).contiguous()
            gx = x.permute(0, 3, 1, 2).reshape(1, B * C, H, W).contiguous()
            gw = w.permute(0, 4, 3, 1, 2).reshape(B * cout, C, 3, 3).contiguous()
            conv_bwd = lambda mask: torch.ops.aten.convolution_backward(  # noqa: E731
                gy, gx, gw, None, [2, 2], [1, 1], [1, 1], False, [0, 0], B, mask)
            runs = {"dx": (lambda: odconv_s2_dx(dy, w, H, W),
                           lambda: odconv_s2_backward_reference(x, w, dy, need_dw=False),
                           lambda: conv_bwd([True, False, False])),
                    "dwmix": (lambda: odconv_s2_dwmix(x, dy),
                              lambda: odconv_s2_backward_reference(x, w, dy, need_dx=False),
                              lambda: conv_bwd([False, True, False]))}
            plain_got = dict(zip(("dx", "dwmix"), odconv_s2_backward_reference(x, w, dy)))
            for name, (kernel, plain, library) in runs.items():
                diff = (got[name].float() - ref[name]).norm().item() / max(ref[name].norm().item(), 1e-30)
                plain_diff = (plain_got[name].float() - ref[name]).norm().item() / max(ref[name].norm().item(), 1e-30)
                err = (got[name].float() - ref[name]).abs().max().item()
                assert diff <= GRAD_TOL[dtype], (row, name, dtype, diff)
                kernel_ms, plain_ms, library_ms = time_ms(kernel), time_ms(plain), time_ms(library)
                bound = bound_ms(x, w)  # each gradient reads and writes the forward's bytes and does its FLOPs
                if dtype == torch.bfloat16:  # the launch plan: tile configuration (and split) of ops/odconv.py
                    extra = (f" plan (tiles {_dx_plan(C)})" if name == "dx" else
                             " plan (tiles {}, split {})".format(*_dw_plan(B, H, W, C, cout)))
                else:
                    extra = f" split {_dw_split(B, H, W, C, cout)}" if name == "dwmix" else ""
                print(f"odconv_s2_{name} {cfg_name} row {row} x{tuple(xs)} cout {cout} {str(dtype)[6:]}{extra}: "
                      f"kernel_ms {kernel_ms:.4f} plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} bound_ms "
                      f"{bound[0]:.4f} ({bound[1]}) x bound {kernel_ms / bound[0]:.1f} rel norm err {diff:.2e} "
                      f"(plain {plain_diff:.2e}) max_abs_err {err:.3e}")
                if dtype == torch.bfloat16:
                    add_site(sums[name], 1, kernel_ms, plain_ms, library_ms, bound, err)
            if dtype == torch.bfloat16:  # what a strided dy costs: the NCHW-contiguous grad viewed NHWC
                strided = dy.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
                print(f"odconv_s2 {cfg_name} row {row}: making a strided bf16 dy contiguous takes "
                      f"{time_ms(lambda: strided.contiguous()):.4f} ms")
    return sums["dx"], sums["dwmix"]


def write_shapes_split(root: Path, split: str, n: int, rng: np.random.Generator) -> int:
    """n synthetic 640x480 JPEGs under root/split/images, labelled with the
    shapes drawn in them (rectangle 0, disc 1). Returns the label count."""
    (root / split / "images").mkdir(parents=True)
    (root / split / "labels").mkdir()
    n_labels = 0
    for i in range(n):
        im, boxes = synthetic_shapes(rng, 480, 640)
        assert cv2.imwrite(str(root / split / "images" / f"{split}{i:03d}.jpg"), im)
        xywhn = xyxy2xywhn(boxes[:, 1:5], w=640, h=480)
        (root / split / "labels" / f"{split}{i:03d}.txt").write_text(
            "".join(f"{int(c)} " + " ".join(f"{v:.6f}" for v in b) + "\n" for c, b in zip(boxes[:, 0], xywhn)))
        n_labels += len(boxes)
    return n_labels


def dead_rows(model) -> set:
    """The rows of a DetectionModel whose output no path to its last row
    reads (zoo-asf's C2fEMACBAM at row 29: the rows inserted after it read
    around it)."""
    n = len(model.model)
    live, todo = set(), [n - 1]
    while todo:
        i = todo.pop()
        if i in live or i < 0:
            continue
        live.add(i)
        f = list(model.head_from) if i == n - 1 and model.head_from else model.froms[i]
        todo += [i - 1 if j == -1 else i + j if j < 0 else j for j in ([f] if isinstance(f, int) else f)]
    return set(range(n)) - live


def step_grads(model, loss_fn, images: np.ndarray, targets: np.ndarray, amp_dtype=None):
    """(loss, gradients of every parameter) of one train-mode forward and
    backward in the model's dtype, or with the forward under autocast to
    `amp_dtype` as the train step runs it; the BatchNorm statistics move as
    a train step moves them. The parameters of dead_rows get zeros, as
    jax.grad gives them; any other parameter the loss does not reach
    fails."""
    model.train()
    dtype = next(model.parameters()).dtype
    with torch.autocast("cuda", dtype=amp_dtype) if amp_dtype else contextlib.nullcontext():
        preds = model(upload_images(images, torch.device("cuda")).to(dtype))
    loss, _ = loss_fn(preds, torch.as_tensor(targets, device="cuda"))
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    dead = {str(i) for i in dead_rows(model)}
    unused = {n for (n, _), g in zip(named, grads) if g is None}
    assert unused == {n for n, _ in named if n.split(".")[1] in dead}, sorted(unused)
    return loss.detach(), [torch.zeros_like(p) if g is None else g for (_, p), g in zip(named, grads)]


def bn_stats(model) -> list:
    return [t.detach().clone() for m in model.modules() if isinstance(m, (FlaxBatchNorm1d, FlaxBatchNorm2d))
            for t in (m.running_mean, m.running_var)]


def offset_heads(model) -> list:
    """(parameter name, is DCNv3's offset head) of every DCNv2 and DCNv3
    offset/mask head's weight and bias."""
    heads = []
    for name, m in model.named_modules():
        if isinstance(m, DCNv2):
            heads += [(f"{name}.conv_offset_mask.{leaf}", False) for leaf in ("weight", "bias")]
        elif isinstance(m, DCNv3):
            heads += [(f"{name}.{head}.{leaf}", head == "offset") for head in ("offset", "mask")
                      for leaf in ("weight", "bias")]
    return heads


def train_step_parity(root: Path, cfg_name: str = "yolo-somi", heads: str = None, cfg: dict = None,
                      loss_cls=ComputeLoss, temper=None) -> None:
    """Phase 8(b): one full-width f32 step (b2, 640 px, seed-0 weights, head
    tempered) through the kernels against the same step under
    plain_version(), each held against the plain step in f64: the loss,
    every parameter's gradient, the BatchNorm statistics after the step,
    and non-zero gradients of the ODConv banks. For yolo-somi-dcn (phase
    9b) the offset heads are random (`heads` "random") or at their zero
    init ("zero"), and every offset/mask head's gradient is non-zero in
    both the kernels' and the f64 step. At the zero init every sampling
    point is an integer, where DCNv3's offset gradient is one-sided: the
    kernel's closed-form coordinates are exact integers, the plain
    version's normalised ones land an ulp to either side in f32 and in
    f64, so that head's gradient (the heads' zero weights pass nothing
    upstream) is held to be non-zero and finite only; DCNv2's coordinates
    are exact integers in all three, so its heads are held as every
    parameter is.

    A fixed relative tolerance between the two f32 steps cannot hold: the
    forward kernel's rounding (3e-5 of the loss) moves the full-width
    model's gradients by a median of a few percent, at b2 and at b8 alike
    (the plain f32 step's gradients lie a median 3.4e-2 from f64 on the
    H100). train_step_witness holds the gradient kernels tightly behind a
    shared forward. Here each parameter's gradient passes where the
    kernels' f32 step is no further from f64 than four times the larger of
    the plain f32 step's distance for that parameter and its median
    distance over all of them
    (both are draws of the same rounding noise; a wrong gradient is off by
    its own size), plus STEP_PARAM_FLOOR[cfg_name] times the largest gradient's norm
    for gradients that are zero in exact arithmetic (a per-channel shift
    ahead of a train-mode BatchNorm, e.g. EMA-CBAM's GroupNorm bias, has
    none). The loss and the BatchNorm statistics are held to twice the
    plain step's distance plus STEP_FLOORS[cfg_name]. With random offset
    heads both f32 steps of yolo-somi-dcn lie far from f64 (a median ~0.7
    to 1.0 of each gradient, 1e-3 of the loss: the data-dependent offsets
    feed rounding back into where the next layer samples), so there this
    check only catches what is grossly wrong; the witness (9c) and the
    per-launch checks are the tight ones. Phase 16(b) passes the
    flagship's body under DetectV8 as `cfg` (its `cfg_name` a label) with
    ComputeLossV8 as `loss_cls` and dfl_prior as `temper`, in place of
    temper_head."""
    model, meta = build_model(cfg or load_model_cfg(find_config(cfg_name)), nc=10, device="cuda", seed=0)
    if temper is None:
        temper_head(model, HEAD_TEMPER)
    else:
        temper(model, meta)
    if heads == "random":
        randomize_offset_heads(model, seed=0)
    plain_model, f64_model = copy.deepcopy(model), copy.deepcopy(model).double()
    nudged_model = copy.deepcopy(model) if cfg_name in STEP_SECOND_DRAW else None
    if nudged_model is not None:
        with torch.no_grad():
            for q in nudged_model.parameters():
                q.mul_(1 + 2 ** -23)
    loss_fn = loss_cls(meta, load_hyp(find_config("hyp.visdrone", "hyps")))
    images, targets, _, _ = next(iter(DataLoader(DetectionDataset(str(root / "train" / "images"), img_size=IMGSZ), 2)))
    seen = []  # the layout each upstream gradient arrives in
    backward = OdconvS2Function.backward

    def spy(ctx, dy):
        seen.append(dy.is_contiguous())
        return backward(ctx, dy)

    reset_counts()
    OdconvS2Function.backward = staticmethod(spy)
    try:
        loss_k, grads_k = step_grads(model, loss_fn, images, targets)
    finally:
        OdconvS2Function.backward = backward
    launches = launch_counts()
    reset_counts()
    with plain_version():
        loss_p, grads_p = step_grads(plain_model, loss_fn, images, targets)
        grads_n = step_grads(nudged_model, loss_fn, images, targets)[1] if nudged_model is not None else None
        torch.cuda.empty_cache()
        loss_d, grads_d = step_grads(f64_model, loss_fn, images, targets)
    assert launches == only(**STEP_LAUNCHES[cfg_name]), launches
    assert not any(launch_counts().values()), launch_counts()

    def rel(a, ref):
        return (a.double() - ref).norm().item() / max(ref.norm().item(), 1e-300)

    names = [n for n, _ in model.named_parameters()]
    one_sided = {n for n, v3_offset in offset_heads(model) if v3_offset and heads == "zero"}
    floor = STEP_PARAM_FLOOR[cfg_name] * max(g.norm().item() for g in grads_d)
    p_median = statistics.median(rel(gp, gd) for gp, gd in zip(grads_p, grads_d))
    n_median = statistics.median(rel(gn, gd) for gn, gd in zip(grads_n, grads_d)) if grads_n else 0.0
    worst, ratios = None, []
    for i, (name, gk, gp, gd) in enumerate(zip(names, grads_k, grads_p, grads_d)):
        assert torch.isfinite(gk).all(), name
        ek, ep, nd = (gk.double() - gd).norm().item(), (gp.double() - gd).norm().item(), gd.norm().item()
        if grads_n:  # the nudged plain step: a second draw of the rounding noise
            ep = max(ep, (grads_n[i].double() - gd).norm().item())
        ratios.append(ek / max(ep, 1e-300))
        if ek > 4 * max(ep, max(p_median, n_median) * nd) + floor and name not in one_sided:
            worst = (name, ek, ep, nd)
    k_rel = sorted(rel(gk, gd) for gk, gd in zip(grads_k, grads_d))
    p_rel = sorted(rel(gp, gd) for gp, gd in zip(grads_p, grads_d))
    bn_k, bn_p, bn_d = bn_stats(model), bn_stats(plain_model), bn_stats(f64_model)
    bn_ek = max(rel(a, c) for a, c in zip(bn_k, bn_d))
    bn_ep = max(rel(b, c) for b, c in zip(bn_p, bn_d))
    banks = [n for n, m in model.named_modules() if isinstance(m, ODConv2d)]
    bank_norms = [grads_k[names.index(f"{b}.weight")].norm().item() for b in banks]
    bank_rel = [(rel(grads_k[names.index(f"{b}.weight")], grads_d[names.index(f"{b}.weight")]),
                 rel(grads_p[names.index(f"{b}.weight")], grads_d[names.index(f"{b}.weight")])) for b in banks]
    head_rel = [(n, grads_k[names.index(n)].norm().item(), grads_d[names.index(n)].norm().item(),
                 rel(grads_k[names.index(n)], grads_d[names.index(n)]),
                 rel(grads_p[names.index(n)], grads_d[names.index(n)])) for n, _ in offset_heads(model)]
    lk, lp, ld = loss_k.item(), loss_p.item(), loss_d.item()
    if head_rel:
        print(f"train step parity {cfg_name} offset heads ({heads}): gradient norm kernels / f64, relative distance "
              f"to f64 kernels / plain: " + "; ".join(f"{n} {a:.3e} / {b:.3e}, {c:.1e} / {d:.1e}"
                                                     for n, a, b, c, d in head_rel))
    tempered = f"head tempered by {HEAD_TEMPER}" if temper is None else f"head under {temper.__name__}"
    print(f"train step parity {cfg_name} f32 b2 {IMGSZ} px (full width, {tempered}), "
          f"against the plain step "
          f"in f64: loss {lk:.7f} kernels, {lp:.7f} plain, {ld:.7f} f64; {len(names)} parameter gradients, relative "
          f"norm distance to f64: kernels median {statistics.median(k_rel):.2e} max {k_rel[-1]:.2e}, plain median "
          f"{statistics.median(p_rel):.2e} max {p_rel[-1]:.2e}"
          + (f", plain from parameters nudged one ulp median {n_median:.2e}" if grads_n else "")
          + f"; kernel/plain distance ratio median "
          f"{statistics.median(ratios):.2f} max {max(ratios):.2f}; BatchNorm statistics after the step: kernels "
          f"{bn_ek:.2e}, plain {bn_ep:.2e}; ODConv bank gradient norms {', '.join(f'{v:.3e}' for v in bank_norms)} "
          f"(to f64, kernels / plain: {', '.join(f'{a:.1e} / {b:.1e}' for a, b in bank_rel)}); "
          f"launches {launches}; upstream gradients contiguous: {seen}")
    loss_floor, bn_floor = STEP_FLOORS[cfg_name]
    assert abs(lk - ld) <= 2 * abs(lp - ld) + loss_floor * abs(ld), (lk, lp, ld)
    assert worst is None, worst
    if cfg_name == "yolo-somi-dcn":
        assert statistics.median(k_rel) <= STEP_MEDIAN_RATIO * statistics.median(p_rel), (k_rel, p_rel)
    assert bn_ek <= 2 * bn_ep + bn_floor, (bn_ek, bn_ep)
    assert len(bank_norms) == 4 and all(v > 0 for v in bank_norms), bank_norms
    assert all(a > 0 and b > 0 and np.isfinite(a) for _, a, b, _, _ in head_rel), head_rel
    del model, plain_model, f64_model, nudged_model, grads_k, grads_p, grads_n, grads_d
    torch.cuda.empty_cache()


def plain_backward(ctx, dy):
    """OdconvS2Function's backward with autograd of the plain version in
    place of the gradient kernels, computed as the kernels compute: in f32
    on the saved operands, rounded to their dtype once (train_step_witness;
    in f32 that is the plain version as it runs). cuDNN's deterministic
    algorithms: the default choice for this f32 grouped-conv backward sums
    with atomics, so the reference, and with it every bf16 gradient behind
    it, would differ from one process to the next."""
    x, wmix = ctx.saved_tensors
    kept = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        grads = odconv_s2_backward_reference(x.float(), wmix.float(), dy.contiguous().float(), ctx.needs_input_grad[0],
                                             ctx.needs_input_grad[1])
    finally:
        torch.backends.cudnn.deterministic = kept
    return tuple(None if g is None else g.to(x.dtype) for g in grads)


def dcnv2_plain_backward(ctx, dcols):
    """Dcnv2Im2colFunction's backward with autograd of the plain version in
    place of dcnv2_im2col_bwd, in f32 on the saved operands, rounded once."""
    saved = ctx.saved_tensors
    grads = dcnv2_im2col_backward_reference(*(t.float() for t in saved), dcols.contiguous().float(), *ctx.geometry)
    return tuple(g.to(saved[0].dtype) if n else None for g, n in zip(grads, ctx.needs_input_grad[:4])) + (None,) * 3


def dcnv3_plain_backward(ctx, dout):
    """Dcnv3CoreFunction's backward with autograd of the plain version in
    place of dcnv3_core_bwd, in f32 on the saved operands, rounded once."""
    saved = ctx.saved_tensors
    grads = dcnv3_core_backward_reference(*(t.float() for t in saved), dout.contiguous().float(), *ctx.args,
                                          offset_scale=ctx.offset_scale)
    return tuple(g.to(saved[0].dtype) if n else None for g, n in zip(grads, ctx.needs_input_grad[:3])) + (None,) * 2


def odconv_launch_errors(ctx, dy, grads) -> tuple:
    """(dx, dwmix) of one gradient launch against the plain version in f32
    on its own operands, relative norm."""
    x, wmix = ctx.saved_tensors
    ref = odconv_s2_backward_reference(x.float(), wmix.float(), dy.float())
    return tuple(rel_err(g, r) for g, r in zip(grads, ref))


def dcnv2_launch_errors(ctx, dcols, grads) -> tuple:
    ref = dcnv2_im2col_backward_reference(*(t.float() for t in ctx.saved_tensors), dcols.float(), *ctx.geometry)
    return tuple(rel_err(g, r) for g, r in zip(grads, ref))


def dcnv3_launch_errors(ctx, dout, grads) -> tuple:
    value, offset, mask = ctx.saved_tensors
    ref = dcnv3_core_backward_reference(value.float(), offset.float(), mask.float(), dout.float(), *ctx.args,
                                        offset_scale=ctx.offset_scale)
    keep = same_corners(offset, value.shape[1], value.shape[2], ctx.args)
    return tuple(rel_err(g, r, k) for g, r, k in zip(grads, ref, (None, keep, None)))


def cudnn_backward(ctx, dy):
    """The plain version's gradients in the operands' dtype: in bf16,
    cuDNN's grouped-conv backward, which rounds in its own way
    (train_step_witness prints its distance)."""
    x, wmix = ctx.saved_tensors
    return odconv_s2_backward_reference(x, wmix, dy.contiguous(), ctx.needs_input_grad[0], ctx.needs_input_grad[1])


# per model, the gradient kernels train_step_witness holds: their autograd
# Function, the plain backward that stands in for them, the check of one of
# their launches, and the launch counters of the kernels they replace
WITNESS = {
    "yolo-somi": [(OdconvS2Function, plain_backward, odconv_launch_errors, ("odconv_s2_dx", "odconv_s2_dwmix"))],
    "yolo-somi-dcn": [(Dcnv2Im2colFunction, dcnv2_plain_backward, dcnv2_launch_errors, ("dcnv2_im2col_bwd",)),
                      (Dcnv3CoreFunction, dcnv3_plain_backward, dcnv3_launch_errors, ("dcnv3_core_bwd",))],
}


def step_with_backward(backwards: dict, model, loss_fn, images, targets, amp_dtype):
    """step_grads with each autograd Function's backward in `backwards`
    ({Function: backward}) replaced, and the launches it made."""
    reset_counts()
    kept = {fn: fn.backward for fn in backwards}
    for fn, backward in backwards.items():
        fn.backward = staticmethod(backward)
    try:
        out = step_grads(model, loss_fn, images, targets, amp_dtype)
    finally:
        for fn, backward in kept.items():
            fn.backward = backward
    return out, launch_counts()


def train_step_witness(root: Path, seed: int, amp_dtype=None, cfg_name: str = "yolo-somi") -> None:
    """Phase 8(b) (9c for yolo-somi-dcn), second witness: the full-width
    step at b8 (weights from `seed`, head tempered; DCN offset heads
    randomised) through the kernels, in f32 or (amp_dtype bfloat16) under
    autocast as train.run trains, against the same step whose gradient
    kernels of WITNESS[cfg_name] (ODConv's; DCNv2's and DCNv3's) are
    replaced by autograd of the plain version behind the same forward
    kernels, computed in f32 and rounded once. The forward is then the
    same bits (the loss and the BatchNorm statistics are held bitwise), so
    the two steps differ only by those kernels' summation order, carried
    back through a fixed graph: each parameter's gradient within
    WITNESS_TOL[dtype] relative norm distance plus WITNESS_FLOOR[dtype]
    times the largest gradient's norm (gradients that are zero in exact
    arithmetic, and in bf16 sums that cancel). In bf16 a gradient element
    whose f32 sum lands on the other side of a rounding boundary differs by
    one bf16 ulp and every bf16 layer behind it rounds again, so bf16 also
    holds the median over the parameters within WITNESS_MEDIAN_TOL (for
    yolo-somi-dcn over those of rows 0-10, which the DCN backward reaches;
    the others' gradients agree bitwise). Each
    of the step's launches of those kernels is held within GRAD_TOL of
    autograd of the plain version in f32 on that launch's own saved
    operands and upstream gradient (DCNv3's doffset where both versions'
    coordinates floor alike). The kernels' step is run twice: the ODConv
    kernels repeat bitwise, and so must the flagship's bf16 step; the DCN
    gradient kernels scatter with f32 atomics, whose order varies, so the
    DCN step's repeat is held to the same limits as the comparison with
    the plain backward (WITNESS_TOL, WITNESS_FLOOR and, in bf16, the
    median), its distance printed. Printed beside, not held: in bf16 for
    the flagship the step with cuDNN's bf16 backward (cudnn_backward), and
    the step under plain_version(), whose gradients differ from the
    kernels' by a median of a few percent at b8 in f32 as at b2
    (train_step_parity). Per-parameter distances go to
    chiprun_out/witness_<cfg>_<dtype>_seed<seed>.json."""
    dtype = amp_dtype or torch.float32
    dcn = cfg_name == "yolo-somi-dcn"
    model, meta = build_model(load_model_cfg(find_config(cfg_name)), nc=10, device="cuda", seed=seed,
                              compute_dtype=amp_dtype)
    temper_head(model, HEAD_TEMPER)
    if dcn:
        randomize_offset_heads(model, seed=seed)
    again_model, back_model, plain_model = (copy.deepcopy(model) for _ in range(3))
    cudnn_model = copy.deepcopy(model) if amp_dtype is not None and not dcn else None
    loss_fn = ComputeLoss(meta, load_hyp(find_config("hyp.visdrone", "hyps")))
    images, targets, _, _ = next(iter(DataLoader(DetectionDataset(str(root / "train" / "images"), img_size=IMGSZ),
                                                 BATCH)))
    in_step = []  # each held kernel launch of the kernels' step: its relative errors against the plain version

    def seen(fn, errors):
        kernels = fn.backward

        def backward(ctx, dy):
            grads = kernels(ctx, dy)
            in_step.append(errors(ctx, dy.contiguous(), [g for g in grads if g is not None]))
            return grads
        return backward

    swaps = WITNESS[cfg_name]
    (loss_k, grads_k), launches = step_with_backward({fn: seen(fn, errors) for fn, _, errors, _ in swaps}, model,
                                                     loss_fn, images, targets, amp_dtype)
    reset_counts()
    _, grads_k2 = step_grads(again_model, loss_fn, images, targets, amp_dtype)
    launches_again = launch_counts()
    (loss_b, grads_b), launches_b = step_with_backward({fn: plain for fn, plain, _, _ in swaps}, back_model,
                                                       loss_fn, images, targets, amp_dtype)
    if cudnn_model is not None:
        (loss_c, grads_c), _ = step_with_backward({OdconvS2Function: cudnn_backward}, cudnn_model, loss_fn, images,
                                                  targets, amp_dtype)
    reset_counts()
    with plain_version():
        loss_p, grads_p = step_grads(plain_model, loss_fn, images, targets, amp_dtype)
    expected = STEP_LAUNCHES[cfg_name]
    swapped = {name for *_, names in swaps for name in names}
    assert launches == launches_again == only(**expected), (launches, launches_again)
    assert launches_b == only(**{k: v for k, v in expected.items() if k not in swapped}), launches_b
    assert not any(launch_counts().values()), launch_counts()
    names = [n for n, _ in model.named_parameters()]
    floor = WITNESS_FLOOR[dtype] * max(g.norm().item() for g in grads_b)
    tol = WITNESS_TOL[dtype]

    def distances(grads, ref):
        d = [((g - r).norm().item(), r.norm().item()) for g, r in zip(grads, ref)]
        return d, sorted(((a / max(n, 1e-30), name) for (a, n), name in zip(d, names)), reverse=True)

    def summary(rel):
        v = [r for r, _ in rel]
        return (f"median {statistics.median(v):.2e}, 90th percentile {v[len(v) // 10]:.2e}, max {v[0]:.2e} "
                f"({rel[0][1]}), next {', '.join(f'{r:.1e} ({n})' for r, n in rel[1:3])}")

    def least(dist):  # the least limit that would pass
        return max((a - floor) / max(n, 1e-30) for a, n in dist)

    dist_b, rel_b = distances(grads_k, grads_b)
    dist_again, rel_again = distances(grads_k, grads_k2)
    over = [(name, a, n) for (a, n), name in zip(dist_b, names) if a > tol * n + floor]
    over_again = [(name, a, n) for (a, n), name in zip(dist_again, names) if a > tol * n + floor]
    # the medians over the parameters the held kernels' gradients reach: for
    # yolo-somi-dcn those of graph rows 0-10 (the head's and the neck's
    # gradients are computed before the DCN backward runs and agree bitwise)
    reached = set(names)
    if dcn:
        last = max(i for i, m in enumerate(model.model) if any(isinstance(x, (DCNv2, DCNv3)) for x in m.modules()))
        reached = {n for n in names if int(n.split(".")[1]) <= last}
    median = statistics.median(r for r, n in rel_b if n in reached)
    median_again = statistics.median(r for r, n in rel_again if n in reached)
    rows = {"names": names, "kernels": dist_b, "again": dist_again}
    bn_k, bn_b, bn_p = bn_stats(model), bn_stats(back_model), bn_stats(plain_model)
    bn_plain = max(((a - c).norm() / c.norm().clamp_min(1e-30)).item() for a, c in zip(bn_k, bn_p))
    lk, lb, lp = loss_k.item(), loss_b.item(), loss_p.item()
    cudnn = ""
    if cudnn_model is not None:
        dist_c, rel_c = distances(grads_c, grads_b)
        rows["cudnn"] = dist_c
        cudnn = (f" The step with cuDNN's bf16 backward (loss {loss_c.item():.7f}) against the f32-rounded one: "
                 f"{summary(rel_c)} (least limit {least(dist_c):.2e}); the kernels against cuDNN's: "
                 f"{summary(distances(grads_k, grads_c)[1])}.")
    tag = f"{'dcn_' if dcn else ''}{'bf16' if amp_dtype else 'f32'}"
    (OUT / f"witness_{tag}_seed{seed}.json").write_text(json.dumps(rows))
    held = " / ".join(f"{fn.__name__}" for fn, *_ in swaps)
    print(f"train step witness {cfg_name} {'bf16 autocast' if amp_dtype else 'f32'} b{BATCH} {IMGSZ} px seed {seed} "
          f"(full width, head tempered by {HEAD_TEMPER}): the step's {held} gradient launches against the plain "
          f"version in f32 on their own inputs: {', '.join('/'.join(f'{e:.1e}' for e in row) for row in in_step)}; "
          f"{len(names)} parameter gradients through the kernels against the plain backward (f32, rounded once) "
          f"behind the same forward kernels (loss {lk:.7f} / {lb:.7f}), relative norm distance {summary(rel_b)}; "
          f"limit {tol:.0e} plus {floor:.2e} absolute (the least limit that passes: {least(dist_b):.2e})"
          + (f", median limit {WITNESS_MEDIAN_TOL:.0e} (median over the {len(reached)} parameters the held "
             f"kernels reach: {median:.2e}; run again {median_again:.2e})" if amp_dtype else "")
          + f". The kernels' step run again: {summary(rel_again)} (least limit {least(dist_again):.2e}).{cudnn} "
          f"Against the step under plain_version() (loss {lp:.7f}, relative {abs(lk - lp) / abs(lp):.2e}; BatchNorm "
          f"statistics {bn_plain:.2e}): {summary(distances(grads_k, grads_p)[1])}. launches {launches}")
    assert torch.isfinite(loss_k) and all(torch.isfinite(g).all() for g in grads_k)
    assert torch.equal(loss_k, loss_b), (lk, lb)
    assert all(torch.equal(a, b) for a, b in zip(bn_k, bn_b)), "the same forward moved the statistics otherwise"
    n_launches = sum(expected[names_[0]] for *_, names_ in swaps)
    assert len(in_step) == n_launches and all(max(e) <= GRAD_TOL[dtype] for e in in_step), in_step
    assert not over, over[:5]
    if amp_dtype is not None:
        assert median <= WITNESS_MEDIAN_TOL, median
    if dcn:  # the atomics' order varies: the repeat is held as the comparison is
        assert not over_again, over_again[:5]
        assert amp_dtype is None or median_again <= WITNESS_MEDIAN_TOL, median_again
    elif amp_dtype is not None:
        assert all(torch.equal(a, b) for a, b in zip(grads_k, grads_k2)), "the kernels' bf16 step did not repeat"
    del model, again_model, back_model, cudnn_model, plain_model, grads_k, grads_k2, grads_b, grads_p
    torch.cuda.empty_cache()


# the port's kernels in a profiler table: (label, substrings of their CUDA kernels' names)
PROFILED = (("odconv_s2 forward", ("odconv_s2_bf16", "odconv_s2_splitk")), ("odconv_s2_dx", ("odconv_s2_dx",)),
            ("odconv_s2_dwmix", ("odconv_s2_dw_", "odconv_s2_bwd_reduce")),
            ("dcnv2_im2col", ("dcnv2_im2col_kernel",)), ("dcnv3_core", ("dcnv3_core_kernel",)),
            ("dcnv2_im2col_bwd", ("dcnv2_im2col_bwd_kernel", "dcnv2_im2col_bwd_sums")),
            ("dcnv3_core_bwd", ("dcnv3_core_bwd_kernel", "dcnv3_core_bwd_sums")))


def profile_train_step(gpu: str, root: Path, cfg_name: str = "yolo-somi") -> None:
    """The full-width bf16 b8 train step alone: median host-clock time of 5
    synchronised steps, then one step under the profiler (busy share; the
    port's kernels' device time by name)."""
    cfg = load_model_cfg(find_config(cfg_name))
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    model, meta = build_model(cfg, nc=10, device="cuda", seed=0, compute_dtype=torch.bfloat16)
    randomize_offset_heads(model, seed=0)
    ds = DetectionDataset(str(root / "train" / "images"), img_size=IMGSZ, augment=True, hyp=hyp)
    batches = list(itertools.islice(DataLoader(ds, BATCH, shuffle=True, drop_last=True), 3))
    opt = make_optimizer(hyp, nb=len(batches), epochs=1, batch_size=BATCH)
    state = create_train_state(model, opt)
    step = make_train_step(ComputeLoss(meta, hyp), opt, amp_dtype=torch.bfloat16)
    for images, targets, _, _ in batches[:2]:  # warm-up
        step(state, images, targets)
    times = []
    for k in range(5):
        images, targets = batches[k % len(batches)][:2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, images, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    images, targets = batches[0][:2]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(state, images, targets)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ours = {name: sum(e.self_device_time_total for e in kernels if any(k in e.key for k in keys)) / 1e3
            for name, keys in PROFILED}
    ours = {name: ms for name, ms in ours.items() if ms > 0}
    path = OUT / f"chip_smoke_profile_train_{cfg_name}.txt"
    path.write_text(f"{gpu}\n{events.table(sort_by='self_device_time_total', row_limit=50)}\n")
    med = statistics.median(times)
    RECORD[f"step {cfg_name}"] = med
    print(f"train step on {gpu}: full-width {cfg_name} bf16 b{BATCH} {IMGSZ} px, median of 5 {med * 1e3:.1f} ms "
          f"({BATCH / med:.1f} img/s; min {min(times) * 1e3:.1f}, max {max(times) * 1e3:.1f}); one profiled step: "
          f"wall {wall_ms:.1f} ms, device kernels {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% busy), "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in ours.items()) + f"; table in {path}")


def train_run(gpu: str, tmp: Path, data: Path, cfg_name: str, labels: tuple) -> dict:
    """Phase 8(c) / 9(d): train.run of the full-width `cfg_name`
    (hyp.visdrone, 640 px, b8, bf16, autoanchor on) for TRAIN_EPOCHS epochs
    and one more from --resume: every logged loss finite, no step skipped,
    STEP_LAUNCHES[cfg_name] launches per train step and the forward kernels
    per val forward (two a batch: the detections' and the val loss's, as
    the JAX val.py does), the weights files written, Runner(last.msgpack)
    serving a b8 batch; then the train step alone, timed and profiled.
    Returns the run's launch counts."""
    kw = dict(cfg=cfg_name, data=str(data), hyp="hyp.visdrone", batch_size=BATCH, imgsz=IMGSZ,
              project=str(tmp / "runs"), name=cfg_name, workers=8, device="cuda")
    run_dir = tmp / "runs" / cfg_name
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    train.run(epochs=TRAIN_EPOCHS, **kw)
    first = [json.loads(line) for line in (run_dir / "train_log.jsonl").read_text().splitlines()]
    train.run(epochs=TRAIN_EPOCHS + 1, weights=str(run_dir / "weights" / "last.ckpt"), resume=True,
              exist_ok=True, **kw)
    launches = launch_counts()
    log = [json.loads(line) for line in (run_dir / "train_log.jsonl").read_text().splitlines()]
    nb = TRAIN_IMAGES // BATCH
    steps = nb * (TRAIN_EPOCHS + 1)
    val_forwards = 2 * -(-VAL_IMAGES // BATCH) * (TRAIN_EPOCHS + 1)
    assert [r["epoch"] for r in log] == list(range(TRAIN_EPOCHS + 1)), [r["epoch"] for r in log]
    assert log[TRAIN_EPOCHS]["opt_step"] == first[-1]["opt_step"] + nb, "the resumed run did not continue the step"
    assert [r["opt_step"] for r in log] == [nb * (e + 1) for e in range(TRAIN_EPOCHS + 1)], "a step was skipped"
    assert all(r["skipped_logged"] == 0 for r in log)
    assert all(np.isfinite(v) for r in log for row in r["logged_losses"] for v in row[1:])
    per_step = STEP_LAUNCHES[cfg_name]
    want = {k: n * (steps + (val_forwards if k in PER_BATCH[cfg_name] else 0)) for k, n in per_step.items()}
    assert launches == only(**want), (launches, want)
    for f in ("last.ckpt", "best.ckpt", "last.msgpack", "best.msgpack"):
        assert (run_dir / "weights" / f).exists(), f
    csv = (run_dir / "results.csv").read_text().splitlines()
    assert csv[0] == "epoch,box,obj,cls,P,R,mAP50,mAP,fitness" and len(csv) == TRAIN_EPOCHS + 2, csv
    runner = Runner(cfg_name, str(run_dir / "weights" / "last.msgpack"), dtype=torch.bfloat16, imgsz=IMGSZ,
                    device="cuda")
    images = next(iter(DataLoader(DetectionDataset(str(data.parent / "val" / "images"), img_size=IMGSZ), BATCH)))[0]
    out = runner(images, conf_thres=0.001)
    assert out.shape == (BATCH, 300, 6) and np.isfinite(out).all(), out.shape
    peak = max(r.get("max_memory_allocated", 0) for r in log)
    RECORD[f"peak {cfg_name}"] = peak
    per = ", ".join(f"{k} {n}" for k, n in per_step.items())
    print(f"train.run on {gpu}: full-width {cfg_name}, hyp.visdrone (mosaic 1.0, mixup 0.2), {IMGSZ} px, b{BATCH}, "
          f"bf16, autoanchor on; {TRAIN_IMAGES} train / {VAL_IMAGES} val 640x480 images ({labels[0]} / {labels[1]} "
          f"self-drawn labels); {TRAIN_EPOCHS} epoch(s), then epoch {log[-1]['epoch']} from --resume (optimizer "
          f"step {first[-1]['opt_step']} -> {log[-1]['opt_step']}); launches per train step {per}, per val forward "
          f"{', '.join(f'{k} {n}' for k, n in PER_BATCH[cfg_name].items())} (whole run {launches}); peak memory "
          f"{peak / 1e9:.2f} GB; weights files written; Runner(last.msgpack) served b{BATCH} with "
          f"{int((out[..., 4] > 0).sum())} rows")
    for r, row in zip(log, csv[1:]):
        print(f"train epoch {cfg_name} {r['epoch']}: {r['steps']} steps in {r['train_s']:.2f} s "
              f"({r['train_s'] / r['steps'] * 1e3:.1f} ms/step, {BATCH * r['steps'] / r['train_s']:.1f} img/s), "
              f"loader wait {r['loader_wait_s'] / r['steps'] * 1e3:.1f} ms/step, val {r['val_s']:.2f} s; "
              f"results.csv: {row}")
    del runner
    profile_train_step(gpu, data.parent, cfg_name)
    return launches


def training(gpu: str) -> dict:
    """Phases 8, 9, 10 and 11, on one self-drawn set: the gradient kernels
    (8a and 9a, in main); for the flagship one full-width f32 step against
    plain_version() and the b8 witnesses (8b), train.run (8c); for
    yolo-somi-dcn the f32 step with random and with zero offset heads (9b),
    the b8 witnesses (9c), train.run (9d); the recipe's train.run cases and
    the remat step (10, its kernel checks in main); the distilled student
    and --evolve (11). Returns each phase 8c / 9d train.run's launch counts
    by config."""
    t_phase = time.perf_counter()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        root = tmp / "shapes"
        rng = np.random.default_rng(0)
        labels = (write_shapes_split(root, "train", TRAIN_IMAGES, rng), write_shapes_split(root, "val", VAL_IMAGES, rng))
        data = root / "data.yaml"
        data.write_text(yaml.safe_dump({"path": str(root), "train": "train/images", "val": "val/images", "nc": 10,
                                        "names": [f"class{i}" for i in range(10)]}))
        train_step_parity(root)
        t_witness = [time.perf_counter()]
        for amp_dtype in (None, torch.bfloat16):
            for seed in WITNESS_SEEDS[amp_dtype or torch.float32]:
                train_step_witness(root, seed, amp_dtype)
            t_witness.append(time.perf_counter())
        t_b = time.perf_counter()
        runs["yolo-somi"] = train_run(gpu, tmp, data, "yolo-somi", labels)
        t_8 = time.perf_counter()
        print(f"training yolo-somi on {gpu}: phase 8 {t_8 - t_phase:.1f} s (8b {t_b - t_phase:.1f} s: the f32 step "
              f"against float64 {t_witness[0] - t_phase:.1f} s, the witnesses f32 {t_witness[1] - t_witness[0]:.1f} s "
              f"and bf16 {t_witness[2] - t_witness[1]:.1f} s; 8c {t_8 - t_b:.1f} s)")
        for heads in ("random", "zero"):
            train_step_parity(root, "yolo-somi-dcn", heads)
        for amp_dtype in (None, torch.bfloat16):
            for seed in DCN_WITNESS_SEEDS[amp_dtype or torch.float32]:
                train_step_witness(root, seed, amp_dtype, "yolo-somi-dcn")
        t_c = time.perf_counter()
        runs["yolo-somi-dcn"] = train_run(gpu, tmp, data, "yolo-somi-dcn", labels)
        print(f"training yolo-somi-dcn on {gpu}: phase 9 {time.perf_counter() - t_8:.1f} s (9b-c {t_c - t_8:.1f} s)")
        recipe(gpu, tmp, data)
        t_11 = time.perf_counter()
        distill_run(gpu, tmp, data)
        distill_step_cost(gpu, root)
        evolve_run(gpu, tmp, data)
        print(f"distillation and evolve on {gpu}: phase 11 {time.perf_counter() - t_11:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# phase 10: the rest of the training recipe
# ---------------------------------------------------------------------------

# train.run's options of each case, one epoch of TRAIN_IMAGES // BATCH steps
RECIPE = (
    ("a", "yolo-somi", dict(multi_scale=True, image_weights=True, cache="ram", rep=True)),
    ("b", "yolo-somi", dict(rect=True)),
    ("c", "yolo-somi", dict(quad=True)),
    ("d", "yolo-somi-dcn", dict(cache="device", multi_scale=True)),
)
SCALES = sorted({max(int(IMGSZ * f) // 32 * 32, 32) for f in train.MULTI_SCALE})  # --multi-scale's sides
RECT_HW = (IMGSZ * 3 // 4, IMGSZ)  # the rect batch of the 640x480 set
# the kernels' shapes that only the recipe gives them: a rect batch (H != W
# at every site), the largest multi-scale square, and quad's images of
# twice the side at a quarter of the batch
RECIPE_SHAPES = ((f"{RECT_HW[0]}x{RECT_HW[1]}", BATCH, RECT_HW), (f"{SCALES[-1]}", BATCH, SCALES[-1]),
                 (f"quad_{2 * IMGSZ}", BATCH // 4, 2 * IMGSZ))
RECIPE_REPS = 5  # time_ms's timed calls at RECIPE_SHAPES
REMAT_SEGMENTS = 4


def recipe_kernels(meta, gen: torch.Generator) -> dict:
    """Phase 10's kernel checks: all seven kernels against their plain
    versions at RECIPE_SHAPES, forward and backward, f32 and bf16, by the
    checks of phases 3, 8a and 9a at these sites, timed with RECIPE_REPS
    calls. Returns {shape label: {kernel name: bf16 summary}}."""
    out = {}
    reps, TIME_REPS[0] = TIME_REPS[0], RECIPE_REPS
    try:
        for label, batch, size in RECIPE_SHAPES:
            sites = odconv_sites(meta, batch, size)
            v2, v3 = dcn_sites("yolo-somi-dcn", batch, size)
            fwd = check_kernel(sites, gen, f"yolo-somi {label}")
            dx, dw = check_backward(sites, gen, f"yolo-somi {label}")
            v2f, v3f = check_dcnv2(v2, gen), check_dcnv3(v3, gen)
            v2b, v3b = check_dcn_backward(v2, v3, gen)
            out[label] = dict(odconv_s2=fwd, odconv_s2_dx=dx, odconv_s2_dwmix=dw, dcnv2_im2col=v2f,
                              dcnv3_core=v3f, dcnv2_im2col_bwd=v2b, dcnv3_core_bwd=v3b)
    finally:
        TIME_REPS[0] = reps
    return out


def recipe_run(gpu: str, tmp: Path, data: Path, label: str, cfg_name: str, opts: dict) -> dict:
    """Phase 10(a)-(d): one epoch of train.run of the full-width `cfg_name`
    (hyp.visdrone, 640 px, b8, bf16, autoanchor off) with `opts`, every
    train step synchronised, timed and its peak memory read: every logged
    loss finite, no step skipped, every step's model input of the shape
    the options give, STEP_LAUNCHES[cfg_name] launches per step and the
    forward kernels' per val forward (two a batch). Prints each shape's
    first step apart from the median of its later ones. Returns the
    shapes drawn and the launch counts."""
    shapes, times, peaks = [], [], []
    inputs = TrainStep.inputs
    call, timed = timed_steps(times, peaks)

    def seen(self, state, images, targets):
        x, t = inputs(self, state, images, targets)
        shapes.append(tuple(x.shape))
        return x, t

    t_run = time.perf_counter()
    TrainStep.inputs, TrainStep.__call__ = seen, timed
    reset_counts()
    try:
        train.run(cfg=cfg_name, data=str(data), hyp="hyp.visdrone", batch_size=BATCH, imgsz=IMGSZ, epochs=1,
                  noautoanchor=True, project=str(tmp / "runs"), name=f"recipe_{label}", workers=8, device="cuda",
                  **opts)
    finally:
        TrainStep.inputs, TrainStep.__call__ = inputs, call
    launches = launch_counts()
    log = json.loads((tmp / "runs" / f"recipe_{label}" / "train_log.jsonl").read_text().splitlines()[0])
    nb = TRAIN_IMAGES // BATCH
    assert log["steps"] == nb == len(times) == len(shapes), (log["steps"], len(times), len(shapes))
    assert log["skipped_logged"] == 0 and all(np.isfinite(v) for row in log["logged_losses"] for v in row[1:])
    val_forwards = 2 * -(-VAL_IMAGES // BATCH)
    want = {k: n * (nb + (val_forwards if k in PER_BATCH[cfg_name] else 0)) for k, n in STEP_LAUNCHES[cfg_name].items()}
    assert launches == only(**want), (label, launches, want)
    if opts.get("multi_scale"):
        assert all(b == BATCH and h == w and h in SCALES for b, _, h, w in shapes), shapes
    elif opts.get("rect"):
        assert all(shp == (BATCH, 3, *RECT_HW) for shp in shapes), shapes
    elif opts.get("quad"):
        assert all(shp == (BATCH // 4, 3, 2 * IMGSZ, 2 * IMGSZ) for shp in shapes), shapes
    by_shape = {}
    for shp, t, peak in zip(shapes, times, peaks):
        by_shape.setdefault(shp, []).append((t, peak))
    # a shape's first step carries a one-off cost, so it prints apart from the later steps
    per = "; ".join(f"{shp[2]}x{shp[3]} b{shp[0]}: first step {v[0][0] * 1e3:.1f} ms"
                    + (f", then median {statistics.median(t for t, _ in v[1:]) * 1e3:.1f} ms of {len(v) - 1}"
                       if len(v) > 1 else "")
                    + f", peak {max(pk for _, pk in v) / 1e9:.2f} GB" for shp, v in sorted(by_shape.items()))
    print(f"recipe ({label}) on {gpu}: train.run of full-width {cfg_name} {opts}, hyp.visdrone, b{BATCH}, bf16, "
          f"1 epoch of {nb} synchronised steps in {time.perf_counter() - t_run:.1f} s (build, val and weights "
          f"files included); shapes in draw order {[f'{h}x{w}' for _, _, h, w in shapes]}; {per}; launches {launches} "
          f"({', '.join(f'{k} {n}' for k, n in STEP_LAUNCHES[cfg_name].items())} a step, every one a kernel's)")
    return {"launches": launches, "shapes": shapes}


def remat_step(gpu: str, root: Path) -> None:
    """Phase 10(e): one b8 bf16 step of the full-width flagship from the same
    state (seed-0 weights, one augmented batch) with --remat REMAT_SEGMENTS
    and without: the peak memory and the time of each; the forward kernel
    launched twice a site under remat (the recompute), the gradient
    kernels once; the BatchNorm statistics and the EMA after the step the
    same bits; every gradient within the bf16 witness's limits of the
    step without remat (WITNESS_TOL and WITNESS_FLOOR, the median within
    WITNESS_MEDIAN_TOL); then the median of 3 more steps of each."""
    cfg = load_model_cfg(find_config("yolo-somi"))
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    ds = DetectionDataset(str(root / "train" / "images"), img_size=IMGSZ, augment=True, hyp=hyp)
    images, targets, _, _ = next(iter(DataLoader(ds, BATCH, shuffle=True, drop_last=True)))
    runs = {}
    for segs in (0, REMAT_SEGMENTS):
        model, meta = build_model(cfg, nc=10, device="cuda", seed=0, compute_dtype=torch.bfloat16)
        opt = make_optimizer(hyp, nb=TRAIN_IMAGES // BATCH, epochs=1, batch_size=BATCH)
        grads, update = [], opt.update

        def keep(opt_state, params, g, *args, **kwargs):  # the gradients the optimizer is handed
            grads.extend(x.detach().clone() for x in g)
            return update(opt_state, params, g, *args, **kwargs)

        opt.update = keep
        state = create_train_state(model, opt)
        step = make_train_step(ComputeLoss(meta, hyp), opt, amp_dtype=torch.bfloat16, remat_segments=segs)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        m = step(state, images, targets)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        launches = launch_counts()
        opt.update = update
        run = dict(first=first, peak=peak, launches=launches, loss=m["loss"].item(), grads=grads[:],
                   bn=bn_stats(model), ema=[t.detach().clone() for t in state.ema.ema.state_dict().values()])
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, images, targets)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        run["median"] = statistics.median(times)
        runs[segs] = run
        del model, state, step, opt
        torch.cuda.empty_cache()
    plain, remat = runs[0], runs[REMAT_SEGMENTS]
    assert plain["launches"] == only(**STEP_LAUNCHES["yolo-somi"]), plain["launches"]
    doubled = dict(STEP_LAUNCHES["yolo-somi"], odconv_s2=2 * STEP_LAUNCHES["yolo-somi"]["odconv_s2"])
    assert remat["launches"] == only(**doubled), remat["launches"]
    assert len(plain["grads"]) == len(remat["grads"]) > 0
    floor = WITNESS_FLOOR[torch.bfloat16] * max(g.norm().item() for g in plain["grads"])
    rel = [(a.float() - b.float()).norm().item() / max(b.float().norm().item(), 1e-30)
           for a, b in zip(remat["grads"], plain["grads"])]
    over = [i for i, (a, b) in enumerate(zip(remat["grads"], plain["grads"]))
            if (a.float() - b.float()).norm().item() > WITNESS_TOL[torch.bfloat16] * b.float().norm().item() + floor]
    bitwise = all(torch.equal(a, b) for a, b in zip(remat["grads"], plain["grads"]))
    print(f"remat on {gpu}: full-width yolo-somi b{BATCH} {IMGSZ} px bf16, one step from the same state: without "
          f"remat {plain['first'] * 1e3:.1f} ms, peak {plain['peak'] / 1e9:.2f} GB; --remat {REMAT_SEGMENTS} "
          f"{remat['first'] * 1e3:.1f} ms, peak {remat['peak'] / 1e9:.2f} GB ({remat['peak'] / plain['peak']:.3f} of "
          f"it); median of 3 more steps {plain['median'] * 1e3:.1f} / {remat['median'] * 1e3:.1f} ms; loss "
          f"{plain['loss']:.7f} / {remat['loss']:.7f}; gradients {'the same bits' if bitwise else 'not bitwise'}, "
          f"relative distance median {statistics.median(rel):.2e} max {max(rel):.2e}; launches "
          f"{plain['launches']} / {remat['launches']}")
    assert not over and statistics.median(rel) <= WITNESS_MEDIAN_TOL, (over[:5], statistics.median(rel))
    assert all(torch.equal(a, b) for a, b in zip(plain["bn"], remat["bn"])), "remat moved the statistics otherwise"
    assert all(torch.equal(a, b) for a, b in zip(plain["ema"], remat["ema"])), "remat changed the EMA"


def recipe(gpu: str, tmp: Path, data: Path) -> dict:
    """Phase 10 on phase 8's set: train.run with the recipe's options
    (RECIPE), then the remat step. Returns each case's sizes and counts."""
    t0 = time.perf_counter()
    runs = {label: recipe_run(gpu, tmp, data, label, cfg_name, opts) for label, cfg_name, opts in RECIPE}
    remat_step(gpu, data.parent)
    print(f"training recipe on {gpu}: phase 10 runs {time.perf_counter() - t0:.1f} s")
    return runs


# ---------------------------------------------------------------------------
# phase 11: distillation and evolve
# ---------------------------------------------------------------------------

STUDENT = "yolo-somi-t-p3"  # the light server of configs/models/yolo-somi-t-p3.yaml's recipe
DISTILL = dict(teacher_cfg="yolo-somi", distill=1.0, distill_hint=0.5)
EVOLVE_GENERATIONS = 2


def timed_steps(times: list, peaks: list):
    """A TrainStep.__call__ that synchronises, times and reads the peak
    memory of every step into `times` and `peaks`."""
    call = TrainStep.__call__

    def timed(self, state, images, targets, aux=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = call(self, state, images, targets, aux)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated())
        return out

    return call, timed


def check_log(log: list) -> None:
    assert all(r["skipped_logged"] == 0 for r in log), "a step was skipped on non-finite gradients"
    assert all(np.isfinite(v) for r in log for row in r["logged_losses"] for v in row[1:])


def distill_run(gpu: str, tmp: Path, data: Path) -> None:
    """Phase 11(a): train.run of the full-width yolo-somi-t-p3 student with
    --teacher (the flagship from seed 0, written as a weights file)
    --teacher-cfg yolo-somi --distill 1.0 --distill-hint 0.5 for one epoch,
    then one more from --resume: odconv_s2 4 launches a step (the
    teacher's forward) and no gradient kernel, the teacher's parameters
    and statistics the same bits after the run, the adapters moved, every
    logged loss finite, last.ckpt carrying kd_adapter_<i> and the resumed
    run continuing its optimizer step; steps timed against phase 8's
    flagship step."""
    teacher_path = tmp / "teacher.msgpack"
    save_model(teacher_path, "yolo-somi", seed=0)
    seen = {}
    make_teacher, plant = train._teacher, train.plant_adapters

    def teacher_spy(*args, **kwargs):
        out = make_teacher(*args, **kwargs)
        seen.setdefault("teacher", (out[0], {k: v.detach().clone() for k, v in out[0].state_dict().items()}))
        return out

    def plant_spy(model, *args, **kwargs):
        shapes = plant(model, *args, **kwargs)
        seen.setdefault("adapters", [getattr(model, f"kd_adapter_{i}").weight.detach().t().cpu().clone()
                                     for i in range(len(shapes))])
        return shapes

    times, peaks = [], []
    call, timed = timed_steps(times, peaks)
    kw = dict(cfg=STUDENT, data=str(data), hyp="hyp.visdrone", batch_size=BATCH, imgsz=IMGSZ, noautoanchor=True,
              project=str(tmp / "runs"), name="distill", workers=8, device="cuda", teacher=str(teacher_path),
              **DISTILL)
    run_dir = tmp / "runs" / "distill"
    nb = TRAIN_IMAGES // BATCH
    t_run = time.perf_counter()
    train._teacher, train.plant_adapters, TrainStep.__call__ = teacher_spy, plant_spy, timed
    reset_counts()
    try:
        train.run(epochs=1, **kw)
        launches = launch_counts()
        first = [json.loads(line) for line in (run_dir / "train_log.jsonl").read_text().splitlines()]
        ckpt = msgpack_restore((run_dir / "weights" / "last.ckpt").read_bytes())
        reset_counts()
        train.run(epochs=2, weights=str(run_dir / "weights" / "last.ckpt"), resume=True, exist_ok=True, **kw)
        resumed = launch_counts()
    finally:
        train._teacher, train.plant_adapters, TrainStep.__call__ = make_teacher, plant, call
    t_run = time.perf_counter() - t_run
    log = [json.loads(line) for line in (run_dir / "train_log.jsonl").read_text().splitlines()]
    check_log(log)
    assert [r["opt_step"] for r in log] == [nb, 2 * nb], "the resumed run did not continue the step"
    assert launches == resumed == only(odconv_s2=4 * nb), (launches, resumed)  # the student has no kernel site
    teacher, before = seen["teacher"]
    assert all(torch.equal(v, before[k]) for k, v in teacher.state_dict().items()), "the teacher changed"
    kernels = [np.asarray(ckpt["params"][f"kd_adapter_{i}"]["kernel"]) for i in range(len(seen["adapters"]))]
    moved = [float(np.abs(k - a.numpy()).max()) for k, a in zip(kernels, seen["adapters"])]
    assert all(m > 0 for m in moved) and all(f"kd_adapter_{i}" in ckpt["ema_params"] for i in range(len(moved)))
    assert [k.shape for k in kernels] == [tuple(a.shape) for a in seen["adapters"]]
    later = times[1:nb] + times[nb + 1:]
    step = statistics.median(later)
    print(f"distill on {gpu}: train.run of full-width {STUDENT} from the full-width flagship (seed 0, a weights "
          f"file) {DISTILL}, hyp.visdrone, b{BATCH}, {IMGSZ} px, bf16: 1 epoch then 1 from --resume (optimizer step "
          f"{first[-1]['opt_step']} -> {log[-1]['opt_step']}) in {t_run:.1f} s; odconv_s2 {launches['odconv_s2'] // nb}"
          f" a step (the teacher's forward), no gradient kernel; teacher the same bits; adapters "
          f"{[k.shape for k in kernels]} moved by max {['%.3e' % m for m in moved]}; step median "
          f"{step * 1e3:.1f} ms (first {times[0] * 1e3:.1f} ms), peak {max(peaks) / 1e9:.2f} GB; phase 8's undistilled "
          f"flagship step {RECORD['step yolo-somi'] * 1e3:.1f} ms, its train.run peak "
          f"{RECORD['peak yolo-somi'] / 1e9:.2f} GB")


def distill_step_cost(gpu: str, root: Path) -> None:
    """Phase 11(b): what the teacher adds to a step. The full-width student
    alone and distilled (hint 0.5) from the same state on one augmented
    b8 batch: the median of 3 synchronised steps each and one profiled
    step each (the device's kernel time)."""
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    ds = DetectionDataset(str(root / "train" / "images"), img_size=IMGSZ, augment=True, hyp=hyp)
    images, targets, _, _ = next(iter(DataLoader(ds, BATCH, shuffle=True, drop_last=True)))
    teacher, t_meta = build_model(load_model_cfg(find_config("yolo-somi")), nc=10, device="cuda", seed=0,
                                  compute_dtype=torch.bfloat16)
    teacher.requires_grad_(False)
    level_map = (1, 2, 3)
    out = {}
    for name in ("alone", "distilled"):
        model, meta = build_model(load_model_cfg(find_config(STUDENT)), nc=10, device="cuda", seed=0,
                                  compute_dtype=torch.bfloat16)
        assert tuple(t_meta.strides.index(s) for s in meta.strides) == level_map
        loss_fn = ComputeLoss(meta, hyp)
        if name == "distilled":
            plant_adapters(model, meta, t_meta, level_map, 0)

            def teacher_apply(t, im):
                with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
                    return t(im, features=True)

            loss_fn = wrap_loss_with_distillation(loss_fn, teacher_apply, meta, teacher_anchors_px=t_meta.anchors_px[
                list(level_map)], level_map=level_map, hint=DISTILL["distill_hint"])
        opt = make_optimizer(hyp, nb=TRAIN_IMAGES // BATCH, epochs=1, batch_size=BATCH)
        state = create_train_state(model, opt)
        step = make_train_step(loss_fn, opt, amp_dtype=torch.bfloat16)
        for _ in range(2):
            step(state, images, targets, aux=teacher)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, images, targets, aux=teacher)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            step(state, images, targets, aux=teacher)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        out[name] = (statistics.median(times), sum(e.self_device_time_total for e in kernels) / 1e3)
        del model, state, step, opt
    (wa, da), (wd, dd) = out["alone"], out["distilled"]
    print(f"distill step on {gpu}: full-width {STUDENT} b{BATCH} {IMGSZ} px bf16, one augmented batch: alone "
          f"{wa * 1e3:.1f} ms wall, {da:.1f} ms device; distilled from the flagship (hint "
          f"{DISTILL['distill_hint']}) {wd * 1e3:.1f} ms wall, {dd:.1f} ms device: the teacher adds "
          f"{(wd - wa) * 1e3:.1f} ms wall and {dd - da:.1f} ms device a step")


def evolve_run(gpu: str, tmp: Path, data: Path) -> None:
    """Phase 11(c): train.run --evolve 2 --epochs 1 of the full-width
    flagship: evolve.csv with a row a generation, each generation's hyps
    other than hyp.visdrone's and inside META's bounds, the runs named
    <name>_gen<i>, and 4 + 4 + 4 launches a step (4 a val forward)."""
    project = tmp / "evolve_runs"
    nb = TRAIN_IMAGES // BATCH
    t0 = time.perf_counter()
    reset_counts()
    best = train.run(cfg="yolo-somi", data=str(data), hyp="hyp.visdrone", batch_size=BATCH, imgsz=IMGSZ, epochs=1,
                     noautoanchor=True, project=str(project), name="evo", workers=8, device="cuda",
                     evolve=EVOLVE_GENERATIONS)
    launches = launch_counts()
    rows = (project / "evolve" / "evolve.csv").read_text().splitlines()
    assert len(rows) == EVOLVE_GENERATIONS + 1 and rows[0].startswith("fitness,"), rows
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    keys = rows[0].split(",")[1:]
    for row in rows[1:]:
        vals = dict(zip(keys, (float(v) for v in row.split(",")[1:])))
        assert all(META[k][1] <= v <= META[k][2] for k, v in vals.items()), row
        assert any(abs(v - hyp[k]) > 1e-6 * max(abs(hyp[k]), 1e-9) for k, v in vals.items()), row
    for g in range(EVOLVE_GENERATIONS):
        check_log([json.loads(line) for line in (project / f"evo_gen{g}" / "train_log.jsonl").read_text().splitlines()])
    val_forwards = 2 * -(-VAL_IMAGES // BATCH)
    per_gen = {k: n * (nb + (val_forwards if k in PER_BATCH["yolo-somi"] else 0))
               for k, n in STEP_LAUNCHES["yolo-somi"].items()}
    assert launches == only(**{k: n * EVOLVE_GENERATIONS for k, n in per_gen.items()}), launches
    print(f"evolve on {gpu}: train.run --evolve {EVOLVE_GENERATIONS} --epochs 1 of the full-width flagship, b{BATCH}, "
          f"{IMGSZ} px, bf16, in {time.perf_counter() - t0:.1f} s; best fitness {best:.5f}; evolve.csv rows "
          f"{[r.split(',')[:4] for r in rows[1:]]} (fitness, lr0, lrf); launches {launches}")


# ---------------------------------------------------------------------------
# phase 12: int8
# ---------------------------------------------------------------------------

INT8_MODES = (("per-tensor", False, ()), ("per-channel", True, ()), ("per-channel, head in bf16", True, ("head",)))
# each int8 val.run three ways: through the kernels; with conv_int8's plain
# version in the kernel's place and every other op as served (the same
# calibration, so the same bits: the kernel's check); under plain_version(),
# whose ODConv rounds otherwise, so the calibration's absmax and with it
# every quantization step move (printed beside the others)
INT8_ROUTES = ("kernels", "conv_int8-plain", "plain_version")


@contextlib.contextmanager
def int8_route(route: str):
    if route == "plain_version":
        with plain_version():
            yield
    elif route == "conv_int8-plain":
        kernel, quant.int8_conv_fused = quant.int8_conv_fused, conv_int8_fused_reference
        try:
            yield
        finally:
            quant.int8_conv_fused = kernel
    else:
        yield


def flat_scales(tree: dict, prefix: str = ""):
    """(flax path, a_scale) of every leaf of a `quant` tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_scales(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)
INT8_REPS = 5  # time_ms's timed calls at each distinct conv_int8 shape


def conv_int8_calls(runner: Runner, images: np.ndarray, exclude=(), per_channel: bool = False) -> dict:
    """Every conv_int8_fused call of one int8 forward of `runner`
    (calibrated on `images`): {shape key: (calls a forward, the first call's
    operands)}. The operands hold x's view (and so its storage) as the
    forward handed it over."""
    calls = {}
    orig = quant.int8_conv_fused

    def spy(x, s_a, w_q, scale, bias, stride, padding, dilation, groups, out_dtype, packed):
        key = (tuple(x.shape), tuple(w_q.shape), tuple(stride), tuple(padding), tuple(dilation), groups,
               bias is not None, out_dtype)
        n, ops = calls.get(key, (0, None))
        calls[key] = (n + 1, ops or (x, s_a, w_q, packed, scale, bias))
        return orig(x, s_a, w_q, scale, bias, stride, padding, dilation, groups, out_dtype=out_dtype, packed=packed)

    quant.int8_conv_fused = spy
    try:
        quant.quantized_infer_fn(runner, images, exclude=exclude, per_channel=per_channel, **EVAL_NMS)(images)
    finally:
        quant.int8_conv_fused = orig
    return calls


def int8_library(x_q, w_q, stride, padding, dilation):
    """The library yardstick of an ungrouped conv on int8 operands: cuBLASLt's
    int8 GEMM, torch._int_mm, on x_q's (M, C) view for a 1x1 conv at stride
    1 without padding, else after an im2col of int8 views (F.unfold refuses
    int8); K and N padded to its multiples of 8 where they are not (then x
    is copied). Returns (fn, the padding it needed)."""
    B, H, W, C = x_q.shape
    N, kh, kw, _ = w_q.shape
    (sh, sw), (ph, pw), (dh, dw) = stride, padding, dilation
    K = kh * kw * C
    Kp, Np = -(-K // 8) * 8, -(-N // 8) * 8
    w2 = torch.zeros((Np, Kp), dtype=torch.int8, device=w_q.device)
    w2[:N, :K] = w_q.reshape(N, K)
    Ho, Wo = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1, (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    pad = [f"K {K}->{Kp}"] * (Kp != K) + [f"N {N}->{Np}"] * (Np != N)
    if (kh, kw, sh, sw, ph, pw) == (1, 1, 1, 1, 0, 0) and Kp == K:
        cols = x_q.view(B * H * W, C)
        return (lambda: torch._int_mm(cols, w2.t())), pad
    xp = F.pad(x_q, (0, 0, pw, pw, ph, ph))

    def fn():
        cols = torch.stack([xp[:, ky * dh: ky * dh + (Ho - 1) * sh + 1: sh, kx * dw: kx * dw + (Wo - 1) * sw + 1: sw]
                            for ky in range(kh) for kx in range(kw)], 3).reshape(B * Ho * Wo, K)
        if Kp != K:
            cols = F.pad(cols, (0, Kp - K))
        return torch._int_mm(cols, w2.t())

    return fn, pad


def int8_class(xs, ws, groups) -> str:
    """The shape class conv_int8's sums are kept by: depthwise, the
    1x1 and the other convs over C % 16 == 0 channels, the head's C = 177
    convs, the one-channel gates, and C = 3 and 98."""
    C, (N, kh, kw, _) = xs[-1], ws
    if groups > 1:
        return "depthwise"
    if C % 16 == 0 and N > 1:
        return "1x1" if kh * kw == 1 else "3x3"
    if C == 177:
        return "C=177"
    return "gates N=1" if N == 1 else "C=3, C=98"


def check_conv_int8(calls: dict, calls_pc: dict) -> dict:
    """conv_int8 at every distinct shape of one int8 forward, on the
    forward's own operands, per tensor (`calls`) and per channel
    (`calls_pc`): conv_int8_fused against conv_int8_fused_reference, and
    the int8-input conv_int8 on the same quantized x against
    conv_int8_reference, the int32 sums and the outputs the same bits; then
    (per tensor, INT8_REPS timed calls, cold L2) the fused kernel, the
    int8-input kernel, the fused plain version, the library on the int8
    operands (ungrouped shapes) and each function's bound: the fused one
    reads x in its own dtype, the int8-input one x_q. The summary sums each
    shape's times by its calls a forward, also by shape class (int8_class);
    library_ms covers the ungrouped shapes only, `kernel_ms_where_library`
    is the fused kernel's time over the same shapes."""
    summary = dict(new_summary(), kernel_ms_where_library=0.0, int8_input_ms=0.0, int8_input_bound_ms=0.0,
                   shapes=len(calls), library_padded=[], classes={})
    assert calls.keys() == calls_pc.keys(), "per-channel forward called other shapes"
    reps, TIME_REPS[0] = TIME_REPS[0], INT8_REPS
    try:
        for key, (count, (x, s_a, w_q, packed, scale, bias)) in sorted(calls.items(), key=lambda kv: -kv[0][0][1]):
            xs, ws, stride, padding, dilation, groups, _, out_dtype = key
            kw = dict(stride=stride, padding=padding, dilation=dilation, groups=groups)
            for ops in ((x, s_a, w_q, packed, scale, bias), calls_pc[key][1]):
                xo, so, wo, po = ops[:4]
                for dtype, sc, b in ((torch.int32, None, None), (out_dtype, ops[4], ops[5])):
                    got = conv_int8_fused(xo, so, wo, sc, b, out_dtype=dtype, packed=po, **kw)
                    torch.cuda.synchronize()
                    ref = conv_int8_fused_reference(xo, so, wo, sc, b, out_dtype=dtype, **kw)
                    assert torch.equal(got, ref), (key, so.dim(), dtype)
            x_q = quantize_activation(x, s_a).contiguous()
            for dtype, sc, b in ((torch.int32, None, None), (out_dtype, scale, bias)):
                got = conv_int8(x_q, w_q, sc, b, out_dtype=dtype, packed=packed, **kw)
                assert torch.equal(got, conv_int8_reference(x_q, w_q, sc, b, out_dtype=dtype, **kw)), (key, dtype)
            fused_ms = time_ms(lambda: conv_int8_fused(x, s_a, w_q, scale, bias, out_dtype=out_dtype, packed=packed,
                                                       **kw))
            int8_ms = time_ms(lambda: conv_int8(x_q, w_q, scale, bias, out_dtype=out_dtype, packed=packed, **kw))
            plain_ms = time_ms(lambda: conv_int8_fused_reference(x, s_a, w_q, scale, bias, out_dtype=out_dtype, **kw))
            library_ms, pad = None, []
            if groups == 1:
                lib, pad = int8_library(x_q, w_q, stride, padding, dilation)
                library_ms = time_ms(lib)
                summary["kernel_ms_where_library"] += count * fused_ms
                summary["library_padded"] += pad
            B, Ho, Wo, N = got.shape
            ops = 2.0 * B * Ho * Wo * N * ws[1] * ws[2] * ws[3]
            out_bytes = got.numel() * got.element_size()
            bound = roofline(x.numel() * x.element_size() + w_q.numel() + out_bytes, ops, PEAK_FLOPS[torch.int8])
            bound_q = roofline(x_q.numel() + w_q.numel() + out_bytes, ops, PEAK_FLOPS[torch.int8])
            add_site(summary, count, fused_ms, plain_ms, library_ms or 0.0, bound, 0.0)
            summary["int8_input_ms"] += count * int8_ms
            summary["int8_input_bound_ms"] += count * bound_q[0]
            cls = summary["classes"].setdefault(int8_class(xs, ws, groups), dict(
                launches=0, ms=0.0, int8_input_ms=0.0, bound_ms=0.0, int8_input_bound_ms=0.0, library_ms=0.0))
            for k, v in (("launches", 1), ("ms", fused_ms), ("int8_input_ms", int8_ms), ("bound_ms", bound[0]),
                         ("int8_input_bound_ms", bound_q[0]), ("library_ms", library_ms or 0.0)):
                cls[k] += count * v
            lib = f"{library_ms:.4f}" + (f" ({', '.join(pad)})" if pad else "") if library_ms is not None else \
                "none: PyTorch has no int8 grouped conv on CUDA"
            plan = _conv_int8_plan(xs, ws, stride, padding, dilation, groups)
            tiles = f"64x{plan.bn}" if plan.route == "gemm" else f"{plan.th}x{plan.tw}x{plan.cb}"
            print(f"conv_int8 yolo-somi x{xs} {str(x.dtype)[6:]} w{ws} s{stride} p{padding} d{dilation} g{groups} "
                  f"x{count}/batch ({plan.route} {tiles}): fused_ms {fused_ms:.4f} int8_input_ms {int8_ms:.4f} "
                  f"plain_ms {plain_ms:.4f} library_ms {lib} bound_ms fused {bound[0]:.4f} ({bound[1]}) int8 input "
                  f"{bound_q[0]:.4f} ({bound_q[1]}) x bound {fused_ms / bound[0]:.1f}; per tensor and per channel, "
                  f"int32 and {str(out_dtype)[6:]} the same bits")
    finally:
        TIME_REPS[0] = reps
    print("conv_int8 by shape class, per batch: " + "; ".join(
        f"{name} x{c['launches']}: fused {c['ms']:.3f} ms (bound {c['bound_ms']:.3f}), int8 input "
        f"{c['int8_input_ms']:.3f} ms (bound {c['int8_input_bound_ms']:.3f}), library {c['library_ms']:.3f} ms"
        for name, c in summary["classes"].items()))
    return summary


def int8_serve(gpu: str) -> dict:
    """Phase 12(c): the full-width flagship (bf16, seed 0) served in int8
    through quantized_infer_fn, calibrated on the first of N_REQUESTS + 1
    b8 uint8 batches: latency and img/s beside phase 4's bf16 serving,
    conv_int8 once per ConvRaw and odconv_s2 4 times a batch, one batch
    profiled. Returns the launch counts of the served batches."""
    runner = Runner("yolo-somi", dtype=torch.bfloat16, imgsz=IMGSZ, device="cuda", seed=0)
    n_convs = len(conv_raw_paths(runner.model))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8) for _ in range(N_REQUESTS + 1)]
    fn = quant.quantized_infer_fn(runner, batches[0], conf_thres=0.25, iou_thres=0.45, max_det=300)
    fn(batches[0])  # warm-up: the weights quantized once, the allocator
    torch.cuda.synchronize()
    reset_counts()
    lat = []
    for images in batches[1:]:
        t0 = time.perf_counter()
        out = fn(images)  # ends in a device->host copy of the detections
        lat.append(time.perf_counter() - t0)
        assert out.shape == (BATCH, 300, 6) and np.isfinite(out).all(), out.shape
    launches = launch_counts()
    assert launches == only(odconv_s2=4 * N_REQUESTS, conv_int8=n_convs * N_REQUESTS), launches
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    # one warm-up step before the recorded one: a window that starts recording with the batch misses its
    # first kernels (one of the 175 conv_int8 launches)
    with torch.profiler.profile(activities=acts, schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                                                  repeat=1)) as prof:
        for _ in range(2):
            t0 = time.perf_counter()
            fn(batches[1])
            wall_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            prof.step()
    events = prof.key_averages()
    # the device's events but the step's own annotation, which spans the whole batch
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and
               not e.key.startswith("ProfilerStep")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    int8_ms = sum(e.self_device_time_total for e in kernels if "conv_int8" in e.key) / 1e3
    int8_n = sum(e.count for e in kernels if "conv_int8" in e.key)
    # the quantize passes PyTorch ran before each conv until the quantize moved into the kernel: each of these
    # ops ran at least once per ConvRaw then
    passes = {name: next(((e.self_device_time_total / 1e3, e.count) for e in events if e.key == name), (0.0, 0))
              for name in ("aten::copy_", "aten::div", "aten::round", "aten::clamp")}
    path = OUT / "chip_smoke_profile_yolo-somi_int8.txt"
    path.write_text(f"{gpu}\n{events.table(sort_by='self_device_time_total', row_limit=40)}\n")
    assert int8_n == n_convs, (int8_n, n_convs, [(e.key[:90], e.count) for e in kernels if "conv_int8" in e.key])
    assert all(passes[name][1] < n_convs for name in ("aten::div", "aten::round", "aten::clamp")), passes
    med, bf16 = statistics.median(lat), RECORD["serve yolo-somi"]
    print(f"serving int8 yolo-somi (quantized_infer_fn, per-tensor, {n_convs} ConvRaws in int8) 640 px b{BATCH} "
          f"conf 0.25, {N_REQUESTS} requests on {gpu}: latency median {med * 1e3:.2f} ms/batch (min "
          f"{min(lat) * 1e3:.2f}, max {max(lat) * 1e3:.2f}), {BATCH / med:.1f} img/s; phase 4's bf16 "
          f"{bf16 * 1e3:.2f} ms/batch, {BATCH / bf16:.1f} img/s; launches conv_int8 {n_convs}/batch, odconv_s2 "
          f"4/batch; profiled batch: wall {wall_ms:.2f} ms, device kernels {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% busy), conv_int8 kernels {int8_ms:.3f} ms in {int8_n} launches; "
          + ", ".join(f"{name} {t:.3f} ms in {n} calls" for name, (t, n) in passes.items()) + f"; table in {path}")
    return launches


def int8_phase(gpu: str, workdir: Path, bf16: tuple) -> tuple:
    """Phase 12 on phase 6's self-labelled set (its bf16 flagship, head
    tempered): (a) conv_int8 against its plain version at every distinct
    ConvRaw shape of a b8 batch; (b) val.run(int8=True) per tensor, per
    channel and per channel with the head in bf16, each through the kernels,
    with conv_int8's plain version and the rest as served (INT8_ROUTES),
    and under plain_version(): the first two with the same calibration and
    mAP@.5 within 0.01; conv_int8 once per quantized ConvRaw per batch and
    odconv_s2 4 times a batch and once for the calibration's forward,
    nothing under plain_version(), whose calibration drift is printed;
    (c) int8 serving (int8_serve). Returns (conv_int8's summary, the
    launches of the served batches)."""
    t_phase = time.perf_counter()
    root = workdir / "ds"
    runner = Runner("yolo-somi", nc=10, dtype=torch.bfloat16, imgsz=IMGSZ, device="cuda", seed=0)
    temper_head(runner.model, HEAD_TEMPER)
    loader = DataLoader(DetectionDataset(str(root / "images"), img_size=IMGSZ), BATCH)
    first = next(iter(loader))[0]
    t0 = time.perf_counter()
    summary = check_conv_int8(conv_int8_calls(runner, first), conv_int8_calls(runner, first, per_channel=True))
    t_kernels = time.perf_counter() - t0
    paths = [p for p, _ in conv_raw_paths(runner.model)]
    head = f"^layers_{len(runner.model.model) - 1}/"
    n_batches = -(-EVAL_IMAGES // BATCH)
    kw = dict(data=str(root / "data.yaml"), batch_size=BATCH, imgsz=IMGSZ, project=str(workdir / "runs"),
              exist_ok=True, dataloader=loader, runner=runner, int8=True)
    for title, per_channel, exclude in INT8_MODES:
        quantized = sum(not any(re.search(head if p == "head" else p, path) for p in exclude) for path in paths)
        runs = {}
        for route in INT8_ROUTES:
            reset_counts()
            t0 = time.perf_counter()
            with int8_route(route):
                res, _, speed = val.run(name=f"int8-{route}", int8_per_channel=per_channel, int8_exclude=exclude, **kw)
            runs[route] = (res, speed, time.perf_counter() - t0, launch_counts(),
                           {k: v for k, v in flat_scales(quant.export_quant_scales(runner.model))})
        (k, ks, kt, kl, k_scales), (c, _, ct, cl, c_scales), (p, _, pt, pl, p_scales) = (runs[r] for r in INT8_ROUTES)
        assert kl == only(odconv_s2=4 * (n_batches + 1), conv_int8=quantized * n_batches), kl
        assert cl == only(odconv_s2=4 * (n_batches + 1)), cl
        assert not any(pl.values()), pl
        assert all(np.array_equal(c_scales[name], v) for name, v in k_scales.items()), "the calibration moved"
        assert abs(k[2] - c[2]) <= 0.01, (title, k[2], c[2])
        drift = [float(np.abs(p_scales[name] / np.maximum(v, 1e-30) - 1).max()) for name, v in k_scales.items()]
        print(f"eval int8 yolo-somi {title} ({quantized} of {len(paths)} ConvRaws in int8): kernels mAP@.5 "
              f"{k[2]:.5f} mAP@.5:.95 {k[3]:.5f}; conv_int8's plain version (the rest as served) mAP@.5 {c[2]:.5f} "
              f"mAP@.5:.95 {c[3]:.5f}; plain_version() mAP@.5 {p[2]:.5f} mAP@.5:.95 {p[3]:.5f}, its calibration "
              f"against the kernels' {sum(d > 0 for d in drift)} of {len(drift)} scales moved, by up to "
              f"{max(drift):.2e}; bf16 (phase 6) mAP@.5 {bf16[2]:.5f} mAP@.5:.95 {bf16[3]:.5f}; kernels "
              f"{EVAL_IMAGES / kt:.1f} img/s ({ks[1]:.2f} ms inference+NMS per image), conv_int8 plain "
              f"{EVAL_IMAGES / ct:.1f}, plain_version() {EVAL_IMAGES / pt:.1f} img/s; launches {kl}")
    launches = int8_serve(gpu)
    print(f"int8 on {gpu}: phase 12 {time.perf_counter() - t_phase:.1f} s (conv_int8 checks {t_kernels:.1f} s)")
    return summary, launches


# ---------------------------------------------------------------------------
# phase 13: data and pipeline parallelism
# ---------------------------------------------------------------------------

DP_WORLD = 2  # gloo ranks sharing cuda:0: one card stands in for two
DP_STEPS = 2
# (config, autocast dtype, steps) of phase 13(a)'s kernel jobs, run by every rank in turn
DP_JOBS = (("yolo-somi", None, DP_STEPS), ("yolo-somi", torch.bfloat16, DP_STEPS), ("yolo-somi-dcn", torch.bfloat16, 1))
DP_F64_BATCH = 4  # the float64 semantics job's global batch (2 images a rank)
# the float64 job against one process: ComputeLoss takes the maps in f32, so
# the loss and the maps' gradient round at f32's 6e-8 (the CPU test's limits)
DP_F64_TOL, DP_F64_FLOOR = 1e-6, 1e-9
# the kernel jobs against one process's steps on the global batch. The
# first step's loss within DP_LOSS relative: the CPU test's 2e-4 in f32. In
# bf16 every layer rounds at 2**-9 and the b4 and b8 forwards round apart
# so far (probe_data_parallel.py, seeds 0-2: -5.4e-3 to -3.4e-2 for the
# program's BatchNorm and for the earlier two-pass form) that per-rank
# BatchNorm statistics, a fault, land among them (-5.8e-2 to +7.5e-3; in
# f32 1.9e-3 to 2.9e-2, which 2e-4 catches): bf16's 1e-1 catches only a
# gross fault (a normaliser off by W). The sharp bf16 check is DP_BN_TOL:
# the running statistics moved by the first step, in the first DP_BN_HELD
# BatchNorms, within DP_BN_TOL relative norm distance of one process's;
# there the forwards have not yet rounded apart (the program's forms: at
# most 7e-8 in bf16 and f32; per-rank statistics 3.1e-3 to 1.3e-2; the
# probe, seeds 0-2). From the fifth BatchNorm on, bf16's rounding shows
# (1.5e-4 to 5.9e-4 there, 0.1 at the last). The rest is printed, not
# held: the seed-0 full-width step amplifies rounding so far (phase 8b: the
# kernels' forward against the plain one moves f32 gradients by a median 3e-2 to
# 1.2e-1 at b8) that the ranks' and the one process's first-step gradients,
# whose forwards round apart at every BatchNorm, lie a median 0.14 apart in
# f32 and 1.4 in bf16 (measured), while the float64 step above agrees to
# 1e-11: the per-element parameter limits of the CPU test (5e-3 relative
# plus 3e-3) and phase 8's bf16 witness limits (each gradient within 1.0
# relative norm plus 1e-4 of the largest, the median within 0.1) cannot
# tell a fault from that rounding here
DP_LOSS = {torch.float32: 2e-4, torch.bfloat16: 1e-1}
DP_BN_HELD, DP_BN_TOL = 2, 1e-4
PIPE_STAGES, PIPE_MICRO = 2, 2
PIPE_TOL = 1e-6  # pipeline_infer against the forward of the same microbatches, relative to each level's largest value


def dp_batch(n: int = BATCH, seed: int = 0):
    """A global batch of n synthetic IMGSZ-square images (uint8 NHWC) and
    their targets (n, 64, 5)."""
    rng = np.random.default_rng(seed)
    images, rows = [], []
    for _ in range(n):
        im, boxes = synthetic_shapes(rng, IMGSZ, IMGSZ)
        images.append(im)
        rows.append(np.concatenate([boxes[:, :1], xyxy2xywhn(boxes[:, 1:5], w=IMGSZ, h=IMGSZ)], 1))
    return np.stack(images), pad_targets(rows, 64)


def dp_model(cfg_name: str, group, amp_dtype=None, dtype=torch.float32):
    """The full-width `cfg_name` from seed 0 (head tempered, DCN offset heads
    randomised), as every rank and the one process build it; broadcast from
    rank 0 under a group, as train.py does."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, meta = build_model(load_model_cfg(find_config(cfg_name)), nc=10, device="cuda", seed=0, dtype=dtype,
                              compute_dtype=amp_dtype)
    temper_head(model, HEAD_TEMPER)
    if cfg_name == "yolo-somi-dcn":
        randomize_offset_heads(model, seed=0)
    if group is not None:
        mesh.replicate_(model)
    return model, meta


def rel_distances(got: list, want: list, tol: float, floor_share: float) -> dict:
    """Each pair's relative norm distance; how many exceed tol x |want| +
    floor_share x the largest |want|. The norms come back in one transfer:
    a rank sharing the card with another waits its turn at every sync."""
    dist = torch.stack([(g - w).norm() for g, w in zip(got, want)]).tolist()
    norm = torch.stack([w.norm() for w in want]).tolist()
    floor = floor_share * max(norm)
    rel = sorted((d / n for d, n in zip(dist, norm) if n > 0), reverse=True)
    return dict(over=sum(d > tol * n + floor for d, n in zip(dist, norm)), median=statistics.median(rel),
                max_rel=rel[0], floor=floor, n=len(want))


def dp_step64(group, images: np.ndarray, targets: np.ndarray, ref_path: str) -> dict:
    """Phase 13(a)'s semantics job: one optimizer step of the full-width
    flagship in float64 under plain_version() (the kernels take f32 and
    bf16) through make_train_step(group=group), so the step's own global
    BatchNorm, loss normalisers, flat gradient all-reduce, finite guard and
    update run: on this rank's rows with a group, or on the global batch in
    one process, whose loss, first momentum buffers (the gradients plus
    the decay term) and parameter updates go to `ref_path`; the ranks hold
    theirs against that file's on the card. The counts are set to 0 just
    before the step and returned."""
    rank, world = (group.rank, group.world) if group is not None else (0, 1)
    secs, t0 = {}, time.perf_counter()
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    model, meta = dp_model("yolo-somi", group, dtype=torch.float64)
    model.register_forward_pre_hook(lambda m, args: (args[0].double(), *args[1:]))  # the step feeds f32
    before = [p.detach().clone() for p in model.parameters()]
    opt = make_optimizer(hyp, nb=1, epochs=1, batch_size=DP_F64_BATCH)
    state = create_train_state(model, opt)
    step = make_train_step(ComputeLoss(meta, hyp), opt, group=group)
    torch.cuda.synchronize()
    secs["build"], t0 = time.perf_counter() - t0, time.perf_counter()
    reset_counts()
    with plain_version():
        m = step(state, mesh.shard_batch(images, rank, world), mesh.shard_batch(targets, rank, world))
    launches = launch_counts()
    torch.cuda.synchronize()
    secs["step"], t0 = time.perf_counter() - t0, time.perf_counter()
    assert bool(m["grads_finite"]), "the float64 step was not finite"
    loss = m["loss"].item()
    bufs = list(state.opt_state.momentum_buf)
    updates = [p.detach() - b for p, b in zip(model.parameters(), before)]
    if group is None:
        torch.save(dict(loss=loss, bufs=[b.cpu() for b in bufs], updates=[u.cpu() for u in updates]), ref_path)
        secs["held"] = time.perf_counter() - t0
        return dict(loss=loss, launches=launches, secs=secs)
    ref = torch.load(ref_path, map_location="cuda")
    out = dict(loss=loss, loss_rel=abs(loss / ref["loss"] - 1), launches=launches,
               bufs=rel_distances(bufs, ref["bufs"], DP_F64_TOL, DP_F64_FLOOR),
               updates=rel_distances(updates, ref["updates"], DP_F64_TOL, DP_F64_FLOOR))
    del model, state, step, bufs, updates, ref
    torch.cuda.empty_cache()
    secs["held"] = time.perf_counter() - t0
    return dict(out, secs=secs)


def dp_job(group, cfg_name: str, amp_dtype, steps: int, images: np.ndarray, targets: np.ndarray,
           ref_path: str) -> dict:
    """`steps` train steps of the full-width `cfg_name` (dp_model), each on
    this rank's rows of the global batch under `group`, or on all of it with
    none. With no group the parameters after the steps, the first step's
    gradients and its moves of the BatchNorm statistics go to `ref_path`;
    with one they are held against that file's on the card and only the
    distances return. Every count is set to 0 just before the steps and read
    just after."""
    rank, world = (group.rank, group.world) if group is not None else (0, 1)
    secs, t_job = {}, time.perf_counter()
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    model, meta = dp_model(cfg_name, group, amp_dtype)
    before = [p.detach().clone() for p in model.parameters()]
    opt = make_optimizer(hyp, nb=steps, epochs=1, batch_size=BATCH)
    state = create_train_state(model, opt)
    bn_before = [b.clone() for b in state.bn_buffers[:2 * DP_BN_HELD]]
    step = make_train_step(ComputeLoss(meta, hyp), opt, amp_dtype=amp_dtype, group=group)
    x, t = mesh.shard_batch(images, rank, world), mesh.shard_batch(targets, rank, world)
    losses, times, finite = [], [], []
    torch.cuda.synchronize()
    secs["build"] = time.perf_counter() - t_job
    reset_counts()
    for i in range(steps):
        t0 = time.perf_counter()
        m = step(state, x, t)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
        finite.append(bool(m["grads_finite"]))
        if i == 0:  # the first step's gradients: SGD's momentum buffers start at 0, less the decay term
            grads = [b - opt.decay * p if g == "weight" else b.clone()
                     for b, p, g in zip(state.opt_state.momentum_buf, before, state.groups)]
            moved = [b - b0 for b, b0 in zip(state.bn_buffers, bn_before)]  # (mean, var) of each BatchNorm
            bn_moves = [torch.cat(moved[k:k + 2]) for k in range(0, len(moved), 2)]
    launches = launch_counts()
    secs["steps"], t0 = sum(times), time.perf_counter()
    params = [p.detach() for p in model.parameters()]
    out = dict(losses=losses, times=times, finite=finite, launches=launches, batch=len(x), secs=secs)
    if group is None:
        torch.save(dict(params=[p.cpu() for p in params], grads=[g.cpu() for g in grads],
                        bn_moves=[m.cpu() for m in bn_moves]), ref_path)
        secs["held"] = time.perf_counter() - t0
        return out
    ref = torch.load(ref_path, map_location="cuda")
    excess = torch.stack([((p - r).abs() - (3e-3 + 5e-3 * r.abs())).max() for p, r in zip(params, ref["params"])])
    excess = excess.max().item()
    digest = hashlib.sha256()
    for p in params:
        digest.update(p.cpu().numpy().tobytes())
    bn = torch.stack([(m - r).norm() / r.norm() for m, r in zip(bn_moves, ref["bn_moves"])]).tolist()
    out.update(excess=excess, digest=digest.hexdigest(), bn=bn,
               grads=rel_distances(grads, ref["grads"], WITNESS_TOL[torch.bfloat16], WITNESS_FLOOR[torch.bfloat16]),
               **rel_distances([p - b for p, b in zip(params, before)],
                               [r - b for r, b in zip(ref["params"], before)],
                               WITNESS_TOL[torch.bfloat16], WITNESS_FLOOR[torch.bfloat16]))
    del model, state, step, ref, params, before, grads
    torch.cuda.empty_cache()
    secs["held"] = time.perf_counter() - t0
    return out


def await_refs(ready: str, timeout: float = 900) -> float:
    """Wait until the parent's one-process references are written (beside_ranks);
    returns the seconds waited."""
    t0 = time.perf_counter()
    while not Path(ready).exists():
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"no one-process references after {timeout} s")
        time.sleep(0.05)
    if Path(ready).read_text() != "ok":
        raise RuntimeError("the one-process references failed")
    return time.perf_counter() - t0


def beside_ranks(world: int, fn, args: tuple, refs, tmp: Path) -> tuple:
    """spawn_local(world, fn, *args, ready) started before this process runs
    `refs()`, the one-process references the ranks are held against: the
    ranks' spawn, chip_smoke's import, the rendezvous and CUDA init overlap
    it, and `fn` calls await_refs(ready) before its first job. Returns
    (refs' result, the ranks' results, seconds from the spawn to the ranks'
    end, seconds of refs)."""
    ready, box = tmp / "refs_ready", {}

    def run():
        try:
            box["ranks"] = mesh.spawn_local(world, fn, *args, str(ready), backend="gloo", timeout=900, threads=4)
        except BaseException as e:  # re-raised in this thread below
            box["error"] = e

    t0 = time.perf_counter()
    thread = threading.Thread(target=run)
    thread.start()
    state = "failed"
    try:
        out = refs()
        t_refs = time.perf_counter() - t0
        state = "ok"
    finally:
        (tmp / "refs_state").write_text(state)
        os.replace(tmp / "refs_state", ready)
        thread.join()
    if "error" in box:
        raise box["error"]
    return out, box["ranks"], time.perf_counter() - t0, t_refs


def dp_ranks(group, f64: dict, jobs: list, t_spawn: float, ready: str) -> tuple:
    """A rank of phase 13(a): the float64 job, then each kernel job, once
    the one-process references are written. Its start (the process's
    spawn, chip_smoke's import and the rendezvous, from the parent's clock
    `t_spawn`), its CUDA init and its wait for the references go with the
    float64 job's seconds."""
    started, t0 = time.time() - t_spawn, time.perf_counter()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    cuda_init = time.perf_counter() - t0
    waited = await_refs(ready)
    f64_out = dp_step64(group, **f64)
    f64_out["secs"].update(start=started, cuda_init=cuda_init, waited=waited)
    return f64_out, [dp_job(group, **job) for job in jobs]


def host_split(secs: dict) -> str:
    """A job's seconds by part, for phase 13(a)'s time line."""
    return "/".join(f"{k} {v:.1f}" for k, v in secs.items())


def data_parallel(gpu: str, tmp: Path) -> dict:
    """Phase 13(a): the float64 semantics job (dp_step64) and each DP_JOBS
    entry in one process on the global batch, then on DP_WORLD gloo ranks
    sharing cuda:0 (spawn_local, started beside the one-process jobs:
    beside_ranks), each rank on its half: the float64
    step's loss, momentum buffers and parameter updates within DP_F64_TOL; for the kernel jobs every rank's launches
    per step, the ranks' parameters and losses the same bits, every step
    finite, and the first step's loss and BatchNorm moves against the one
    process's (DP_LOSS, DP_BN_TOL; the gradient, update and parameter
    distances printed). Returns rank 0's
    launches per job."""
    t_phase = time.perf_counter()
    images, targets = dp_batch()
    f64 = dict(images=images[:DP_F64_BATCH], targets=targets[:DP_F64_BATCH], ref_path=str(tmp / "dp_ref64.pt"))
    jobs = [dict(cfg_name=cfg_name, amp_dtype=amp_dtype, steps=steps, images=images, targets=targets,
                 ref_path=str(tmp / f"dp_ref{i}.pt")) for i, (cfg_name, amp_dtype, steps) in enumerate(DP_JOBS)]
    secs = {}

    def one_process():
        t0 = time.perf_counter()
        ref64 = dp_step64(None, **f64)
        secs["f64"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        out = []
        for job in jobs:
            out.append(dp_job(None, **job))
            torch.cuda.empty_cache()
        secs["jobs"] = time.perf_counter() - t0 - secs["f64"]
        return ref64, out

    (ref64, refs), per_rank, t_spawned, t_refs = beside_ranks(DP_WORLD, dp_ranks, (f64, jobs, time.time()), one_process,
                                                              tmp)
    t_ref64 = secs["f64"]
    print(f"data parallel host time on {gpu}: ranks {t_spawned:.1f} s from their spawn, beside one process's "
          f"references {t_refs:.1f} s: float64 {t_ref64:.1f} s ({host_split(ref64['secs'])}), kernel jobs "
          f"{secs['jobs']:.1f} s ({'; '.join(host_split(r['secs']) for r in refs)}); "
          + "; ".join(f"rank {i} float64 ({host_split(r[0]['secs'])}), kernel jobs "
                      f"({'; '.join(host_split(j['secs']) for j in r[1])})" for i, r in enumerate(per_rank)))
    g64 = [r[0] for r in per_rank]
    print(f"data parallel float64 on {gpu}: full-width yolo-somi under plain_version(), global b{DP_F64_BATCH} at "
          f"{IMGSZ} px on {DP_WORLD} gloo ranks on cuda:0 against one process, one optimizer step through "
          f"make_train_step(group=): loss {g64[0]['loss']:.10f} / {ref64['loss']:.10f} (relative "
          f"{g64[0]['loss_rel']:.2e}); momentum buffers' relative norm distance median {g64[0]['bufs']['median']:.2e}, "
          f"max {g64[0]['bufs']['max_rel']:.2e} ({g64[0]['bufs']['over']} of {g64[0]['bufs']['n']} over "
          f"{DP_F64_TOL:.0e} plus {g64[0]['bufs']['floor']:.2e}); parameter updates median "
          f"{g64[0]['updates']['median']:.2e}, max {g64[0]['updates']['max_rel']:.2e} ({g64[0]['updates']['over']} "
          f"over); launches {g64[0]['launches']}; one process {t_ref64:.1f} s")
    assert all(r["bufs"]["over"] == 0 and r["updates"]["over"] == 0 and r["loss_rel"] <= DP_F64_TOL
               for r in g64), g64
    assert all(r["launches"] == only() for r in g64 + [ref64]), [r["launches"] for r in g64 + [ref64]]
    launches = {}
    for job, ref, ranks in zip(jobs, refs, zip(*[r[1] for r in per_rank])):
        cfg_name, amp_dtype, steps = job["cfg_name"], job["amp_dtype"], job["steps"]
        want = only(**{k: n * steps for k, n in STEP_LAUNCHES[cfg_name].items()})
        assert ref["launches"] == want, (ref["launches"], want)
        assert all(r["launches"] == want for r in ranks), [r["launches"] for r in ranks]
        assert all(r["digest"] == ranks[0]["digest"] for r in ranks), "the ranks' parameters differ"
        assert all(r["losses"] == ranks[0]["losses"] for r in ranks) and all(all(r["finite"]) for r in ranks)
        r0 = ranks[0]
        first_rel = abs(r0["losses"][0] / ref["losses"][0] - 1)
        dtype = amp_dtype or torch.float32
        title = f"{cfg_name} {'bf16 autocast' if amp_dtype else 'f32'}"
        print(f"data parallel {title} on {gpu}: {DP_WORLD} gloo ranks on cuda:0, b{r0['batch']} each of a global "
              f"b{BATCH} at {IMGSZ} px (full width, seed-0 weights, head tempered by {HEAD_TEMPER}), {steps} "
              f"step(s) against one process's b{BATCH}: losses {['%.7f' % v for v in r0['losses']]} / "
              f"{['%.7f' % v for v in ref['losses']]} (first relative {first_rel:.2e}, limit "
              f"{DP_LOSS[dtype]:.0e}); the "
              f"first step's moves of the first {DP_BN_HELD} BatchNorms' statistics, relative norm distance "
              f"{['%.1e' % v for v in r0['bn']]} (limit {DP_BN_TOL:.0e}); "
              f"printed, not held (DP_LOSS's comment): the first step's gradients, relative norm distance: median "
              f"{r0['grads']['median']:.2e}, max {r0['grads']['max_rel']:.2e} ({r0['grads']['over']} over "
              f"{WITNESS_TOL[torch.bfloat16]:.0e} plus {r0['grads']['floor']:.2e}); each parameter's update over the "
              f"steps, "
              f"relative norm distance: median {r0['median']:.2e}, max {r0['max_rel']:.2e} ({r0['over']} of "
              f"{r0['n']} over {WITNESS_TOL[torch.bfloat16]:.0e} plus {r0['floor']:.2e}); the parameters' largest "
              f"excess over 5e-3 x |p| + 3e-3: {r0['excess']:.2e}; step times rank 0 "
              f"{['%.1f ms' % (v * 1e3) for v in r0['times']]}, rank 1 "
              f"{['%.1f ms' % (v * 1e3) for v in ranks[1]['times']]}"
              f", one process {['%.1f ms' % (v * 1e3) for v in ref['times']]} ({CONTENDED}); launches per rank "
              f"{r0['launches']}")
        assert first_rel <= DP_LOSS[dtype], first_rel
        assert all(max(r["bn"]) <= DP_BN_TOL for r in ranks), [r["bn"] for r in ranks]
        launches[f"{cfg_name} {'bf16' if amp_dtype else 'f32'}"] = r0["launches"]
    print(f"data parallel on {gpu}: phase 13a {time.perf_counter() - t_phase:.1f} s (ranks {t_spawned:.1f} s)")
    return launches


def torchrun_start(tmp: Path):
    """Phase 13(b)'s process, started: torchrun --standalone
    --nproc_per_node 1 -m yolosomi_tpu_torch.train over NCCL, one epoch of
    the full-width flagship on phase 8's set (hyp.visdrone, b8, bf16,
    autoanchor on), its output to chiprun_out/chip_smoke_torchrun.log. It
    runs beside 13(a) and 13(c) (its launches count in its own process);
    torchrun_epoch waits for it. Returns (process, log file, start time)."""
    t0 = time.perf_counter()
    root = tmp / "shapes"
    rng = np.random.default_rng(0)
    write_shapes_split(root, "train", TRAIN_IMAGES, rng)
    write_shapes_split(root, "val", VAL_IMAGES, rng)
    data = root / "data.yaml"
    data.write_text(yaml.safe_dump({"path": str(root), "train": "train/images", "val": "val/images", "nc": 10,
                                    "names": [f"class{i}" for i in range(10)]}))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1", "-m",
           "yolosomi_tpu_torch.train", "--cfg", "yolo-somi", "--data", str(data), "--hyp", "hyp.visdrone",
           "--epochs", "1", "--batch-size", str(BATCH), "--imgsz", str(IMGSZ), "--workers", "8",
           "--project", str(tmp / "runs"), "--name", "ddp"]
    OUT.mkdir(exist_ok=True)
    log = open(OUT / "chip_smoke_torchrun.log", "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, text=True, cwd=Path(__file__).resolve().parent)
    return proc, log, t0


def torchrun_epoch(gpu: str, tmp: Path, started) -> None:
    """Phase 13(b), checked: torchrun_start's process ended with code 0;
    one run directory with one last.ckpt, and the epoch's kernel launches
    (train_log.jsonl) STEP_LAUNCHES per step plus odconv_s2 per val
    forward."""
    proc, log, t0 = started
    t_wait = time.perf_counter()
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    out = (OUT / "chip_smoke_torchrun.log").read_text()
    assert proc.returncode == 0, out[-4000:]
    assert "1 data-parallel ranks of 8 images" in out, out[-2000:]
    run = tmp / "runs" / "ddp"
    assert sorted(p.name for p in (tmp / "runs").iterdir()) == ["ddp"]
    assert sorted(p.name for p in (run / "weights").glob("*.ckpt")) == ["best.ckpt", "last.ckpt"]
    log = [json.loads(line) for line in (run / "train_log.jsonl").read_text().splitlines()]
    nb = TRAIN_IMAGES // BATCH
    val_forwards = 2 * -(-VAL_IMAGES // BATCH)
    want = {k: n * (nb + (val_forwards if k in PER_BATCH["yolo-somi"] else 0))
            for k, n in STEP_LAUNCHES["yolo-somi"].items()}
    got = {k: v for k, v in log[0]["kernel_launches"].items() if v}
    assert len(log) == 1 and got == want and log[0]["skipped_logged"] == 0, (log[0]["kernel_launches"], want)
    assert all(np.isfinite(v) for row in log[0]["logged_losses"] for v in row[1:])
    r = log[0]
    print(f"torchrun on {gpu}: --standalone --nproc_per_node 1 -m yolosomi_tpu_torch.train over NCCL, full-width "
          f"yolo-somi, hyp.visdrone, b{BATCH}, {IMGSZ} px, bf16, autoanchor on, {TRAIN_IMAGES} images: 1 epoch, "
          f"{r['steps']} steps in {r['train_s']:.2f} s ({r['train_s'] / r['steps'] * 1e3:.1f} ms/step), val "
          f"{r['val_s']:.2f} s (timed while 13(a) and 13(c) ran on the same card); kernel launches {got} ({nb} steps, {val_forwards} val forwards); "
          f"last.ckpt written once; process {time.perf_counter() - t0:.1f} s, of which waited for after 13(a) and 13(c) "
          f"{time.perf_counter() - t_wait:.1f} s; log in chip_smoke_torchrun.log")


def pipeline(gpu: str) -> None:
    """Phase 13(c): the full-width flagship (f32, seed 0, head tempered) in
    PIPE_STAGES stages, all on cuda:0. At microbatch = batch (b8) the
    pipeline's loss and gradients against one process's step (the loss
    within 1e-5 relative, each gradient at phase 8's f32 witness limits),
    the forward kernel twice a site (the recompute) and each gradient
    kernel once; at microbatch PIPE_MICRO one step with the optimizer,
    finite, and its per-stage parameter bytes; pipeline_infer against the
    model's forward of the same microbatches (PIPE_TOL; the b8 forward
    rounds otherwise, printed)."""
    t_phase = time.perf_counter()
    images, targets = dp_batch()
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    model, meta = build_model(load_model_cfg(find_config("yolo-somi")), nc=10, device="cuda", seed=0)
    temper_head(model, HEAD_TEMPER)
    loss_fn = ComputeLoss(meta, hyp)
    ref = copy.deepcopy(model)
    t0 = time.perf_counter()
    ref_loss, ref_grads = step_grads(ref, loss_fn, images, targets)
    torch.cuda.synchronize()
    t_ref = time.perf_counter() - t0
    ref_grads = dict(zip([n for n, _ in ref.named_parameters()], ref_grads))
    del ref
    devices = ["cuda:0"] * PIPE_STAGES
    trainer = PipelineTrainer(model, loss_fn, PIPE_STAGES, devices=devices, microbatch=BATCH)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    loss = trainer.step(images, targets)
    torch.cuda.synchronize()
    t_pipe = time.perf_counter() - t0
    launches = launch_counts()
    got = {k: v for g in trainer.grads for k, v in g.items()}
    t0 = time.perf_counter()
    trainer.step(images, targets)  # again, timed: the first step carries the stages' one-off costs
    torch.cuda.synchronize()
    t_pipe2 = time.perf_counter() - t0
    assert set(got) == set(ref_grads)
    norm = {k: g.norm().item() for k, g in ref_grads.items()}
    floor = WITNESS_FLOOR[torch.float32] * max(norm.values())
    dist = {k: (got[k] - g).norm().item() for k, g in ref_grads.items()}
    rel = sorted((d / max(norm[k], 1e-30) for k, d in dist.items()), reverse=True)
    over = [k for k, d in dist.items() if d > WITNESS_TOL[torch.float32] * norm[k] + floor]
    loss_rel = abs(loss - ref_loss.item()) / abs(ref_loss.item())
    bounds = trainer.bounds
    del trainer, got, ref_grads
    torch.cuda.empty_cache()
    micro = PipelineTrainer(model, loss_fn, PIPE_STAGES, devices=devices, microbatch=PIPE_MICRO,
                            optimizer=make_optimizer(hyp, nb=1, epochs=1, batch_size=BATCH))
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    loss_micro = micro.step(images, targets)
    torch.cuda.synchronize()
    t_micro = time.perf_counter() - t0
    launches_micro = launch_counts()
    per_stage = micro.per_device_param_bytes()
    del micro
    torch.cuda.empty_cache()
    x = upload_images(images, torch.device("cuda"))
    infer = pipeline_infer(model.eval(), devices, bounds[1], PIPE_MICRO)
    reset_counts()
    maps = infer(x)
    torch.cuda.synchronize()
    launches_infer = launch_counts()
    with torch.no_grad():  # the same microbatches through the whole model, and the batch at once
        per_micro = [torch.cat(level) for level in zip(*(model(x[i:i + PIPE_MICRO])
                                                          for i in range(0, BATCH, PIPE_MICRO)))]
        whole = model(x)

    def err(a, b):
        return max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(a, b))

    infer_err, batch_err = err(maps, per_micro), err(maps, whole)
    n_micro = BATCH // PIPE_MICRO
    print(f"pipeline on {gpu}: full-width yolo-somi f32 in {PIPE_STAGES} stages on {devices} (rows {bounds}), b{BATCH} "
          f"{IMGSZ} px: at microbatch {BATCH} loss {loss:.7f} / one process {ref_loss.item():.7f} (relative "
          f"{loss_rel:.2e}), gradients' relative norm distance median {statistics.median(rel):.2e}, max {rel[0]:.2e} "
          f"({len(over)} over {WITNESS_TOL[torch.float32]:.0e} plus {floor:.2e}), step {t_pipe * 1e3:.1f} ms (again "
          f"{t_pipe2 * 1e3:.1f} ms) against {t_ref * 1e3:.1f} ms (forward and backward, one process; all "
          f"{CONTENDED}), launches "
          f"{launches}; at microbatch "
          f"{PIPE_MICRO} ({n_micro} microbatches, optimizer on) loss {loss_micro:.7f}, step {t_micro * 1e3:.1f} ms, "
          f"launches {launches_micro}, parameter bytes per stage {per_stage}; pipeline_infer at microbatch "
          f"{PIPE_MICRO}: against the same microbatches through the model {infer_err:.2e} of the level's largest "
          f"value, "
          f"against the b{BATCH} forward {batch_err:.2e} (printed), launches {launches_infer}")
    assert loss_rel <= 1e-5 and not over, (loss_rel, over[:5])
    assert launches == only(odconv_s2=8, odconv_s2_dx=4, odconv_s2_dwmix=4), launches
    assert np.isfinite(loss_micro)
    assert launches_micro == only(odconv_s2=8 * n_micro, odconv_s2_dx=4 * n_micro, odconv_s2_dwmix=4 * n_micro)
    assert launches_infer == only(odconv_s2=4 * n_micro), launches_infer
    assert infer_err <= PIPE_TOL, infer_err
    print(f"pipeline on {gpu}: phase 13c {time.perf_counter() - t_phase:.1f} s")


def parallelism(gpu: str) -> dict:
    """Phase 13: (a) data_parallel, (b) torchrun_epoch, its process beside
    (a) and (c), (c) pipeline. Returns (a)'s launches per rank by job."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        started = torchrun_start(Path(tmp))
        try:
            launches = data_parallel(gpu, Path(tmp))
            pipeline(gpu)
        except BaseException:
            started[0].kill()
            started[0].wait()
            started[1].close()
            raise
        torchrun_epoch(gpu, Path(tmp), started)
    print(f"data and pipeline parallelism on {gpu}: phase 13 {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 14: spatial sharding
# ---------------------------------------------------------------------------

SP_WORLD = 2  # gloo ranks sharing cuda:0, one H-strip each (parallel/spatial.py)
SP_BATCH, SP_REPS = 2, 3  # images a batch; timed batches a job, after one untimed
SP_CONF = 0.25
# the yardstick of both dtypes: the unsharded model in float64 under
# plain_version() (phase 5's rule for the kernels' path): a sharded model's
# head maps, level by level, no further from it than SP_RULE times the
# unsharded model's of the same dtype, plus SP_FLOOR of the level's largest
# value (f32 rounding a few hundred ulps deep: at 256 px on the CPU a
# level of the sharded small flagship lay 4.4e-5 from float64 where the
# unsharded one lay 2.1e-5; a wrong halo moves maps by a tenth of their
# values). In f32 the rows too: as many kept as one process keeps, as many
# left unmatched by the float64 rows, scores (plus SP_FLOOR) and boxes
# (plus SP_BOX_FLOOR of the image side, px) no further from them than
# SP_RULE times one process's: a box's largest distance is one row's, a
# noisier yardstick than a level's (at 256 px on the CPU a sharded small
# flagship's rows lay 0.0136 px from float64, the unsharded one's 0.0058;
# a wrong halo moves a box by pixels). In bf16 the rows are
# printed, not held: rounding there moves the kept set itself (the
# unsharded bf16 flagship at 1280 px keeps 2 rows the float64 model does
# not, and its matched scores lie up to 0.74 off, on an NVIDIA H100 80GB
# HBM3 at 700 W)
SP_RULE, SP_FLOOR, SP_BOX_FLOOR = 2.0, 1e-5, 1e-4
# (config, dtype, image side) of the sharded serving jobs
SP_JOBS = (("yolo-somi", torch.float32, 1280), ("yolo-somi", torch.bfloat16, 1280),
           ("yolo-somi-dcn", torch.float32, 640), ("yolo-somi-dcn", torch.bfloat16, 640))


def sp_runner(cfg_name: str, dtype, shards: int = 1) -> Runner:
    """The full-width `cfg_name` from seed 0 (nc 10, head tempered, DCN
    offset heads randomised) in `dtype` on cuda:0, TF32 off; sharded over
    `shards` strips of the running process group when shards > 1."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    runner = Runner(cfg_name, dtype=dtype, device="cuda", seed=0, spatial_shards=shards)
    temper_head(runner.model, HEAD_TEMPER)
    randomize_offset_heads(runner.model, seed=0)
    return runner


def sp_images(size: int) -> np.ndarray:
    return np.random.default_rng(14).integers(0, 256, (SP_BATCH, size, size, 3), dtype=np.uint8)


def level_errors(preds: list, ref: list) -> list:
    """Each head level's largest |pred - ref| and largest |ref|."""
    return [((p.double() - r.double()).abs().max().item(), r.double().abs().max().item()) for p, r in zip(preds, ref)]


def row_distance(got: np.ndarray, want: np.ndarray) -> dict:
    """Each valid row of `got` matched to the nearest free valid row of
    `want` of its class (by its box): the rows left unmatched on either
    side, and the largest box (px) and score distances of the matches."""
    unmatched, box, score = 0, 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g[g[:, 4] > 0].astype(np.float64), w[w[:, 4] > 0].astype(np.float64)
        unmatched += abs(len(g) - len(w))
        free = np.ones(len(w), bool)
        for row in g:
            cand = np.flatnonzero(free & (w[:, 5] == row[5]))
            if not len(cand):
                continue
            d = np.abs(w[cand, :4] - row[:4]).max(1)
            j = cand[np.argmin(d)]
            free[j] = False
            box, score = max(box, d.min()), max(score, abs(w[j, 4] - row[4]))
    return dict(unmatched=unmatched, box=box, score=score)


def largest_allocation(runner: Runner, images: np.ndarray) -> tuple:
    """(MB, maker) of the largest allocation of one forward, from the
    caching allocator's history: the maker is the first frame of its stack
    outside the allocator (a cuDNN plan's workspace shows as
    at::native::run_conv_plan)."""
    torch.cuda.memory._record_memory_history(max_entries=200000)
    try:
        runner.forward(images)
        torch.cuda.synchronize()
        snapshot = torch.cuda.memory._snapshot()
    finally:
        torch.cuda.memory._record_memory_history(enabled=None)
    top = max((e for trace in snapshot["device_traces"] for e in trace if e["action"] == "alloc"),
              key=lambda e: e["size"])
    names = [f.get("name", "") for f in top.get("frames", [])]
    maker = next((m for m in names if "Allocator" not in m and "unwind" not in m and "Traceback" not in m
                  and "gather_with_cpp" not in m), "?")
    return top["size"] / 1e6, re.split(r"[(<]", maker)[0]


def odconv_strip_sites(cfg_name: str, size: int) -> list:
    """odconv_s2's sites in `cfg_name`'s sharded forward of a SP_BATCH x
    size-px batch over SP_WORLD strips, as ODConv2d's strip path calls it:
    each distinct strip height's rows at the site's level plus the two rows
    above them."""
    with torch.device("meta"):
        _, meta = parse_model(load_model_cfg(find_config(cfg_name)))
    plan = strip_plan(size, SP_WORLD, int(max(meta.strides)))
    heights = sorted({b - a for a, b in zip(plan.bounds, plan.bounds[1:])})
    return [(row, (n, h + 2, w, c), ws) for px in heights
            for row, (n, h, w, c), ws in odconv_sites(meta, SP_BATCH, (px, size))]


def sp_ref64(cfg_name: str, size: int, ref_dir: str) -> None:
    """The yardstick: sp_runner's model in float64 under plain_version(),
    one image at a time; its head maps and rows go to `ref_dir`."""
    runner = sp_runner(cfg_name, torch.float64)
    images = sp_images(size)
    with plain_version():
        preds = [torch.cat(levels) for levels in zip(*(runner.forward(images[i:i + 1]) for i in range(SP_BATCH)))]
        out = runner(images, conf_thres=SP_CONF)
    torch.save(dict(preds=[p.cpu() for p in preds], out=torch.from_numpy(out)),
               Path(ref_dir) / f"sp_{cfg_name.replace('/', '_')}_float64.pt")
    del runner, preds
    torch.cuda.empty_cache()


def sp_job(group, cfg_name: str, dtype, size: int, ref_dir: str) -> dict:
    """One serving job: sp_runner's model answers a b2 batch of size-px
    uint8 images. In one process (no group) its head maps and rows go to
    `ref_dir`; on a rank of a group the model runs sharded. Either way its
    distances from the float64 yardstick's maps and rows in `ref_dir` are
    returned, and a rank's from the unsharded model's too. Every count is
    set to 0 just before the forward and read just after it; the peak
    memory above the model's own bytes, the rows kept at SP_CONF and
    SP_REPS timed batches (forward, gather, postprocess) are returned, and
    in one process the largest allocation of a forward."""
    shards = group.world if group is not None else 1
    runner = sp_runner(cfg_name, dtype, shards)
    images = sp_images(size)
    runner(images, conf_thres=SP_CONF)  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    preds = runner.forward(images)
    torch.cuda.synchronize()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    out = runner(images, conf_thres=SP_CONF)
    assert out.shape == (SP_BATCH, 300, 6) and np.isfinite(out).all() and all(torch.isfinite(p).all() for p in preds)
    times = []
    for _ in range(SP_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runner(images, conf_thres=SP_CONF)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    name = f"sp_{cfg_name.replace('/', '_')}"
    ref64 = torch.load(Path(ref_dir) / f"{name}_float64.pt")
    res = dict(launches=launches, peak=peak, model_bytes=base, times=times, kept=int((out[..., 4] > 0).sum()),
               vs64=level_errors(preds, [r.cuda() for r in ref64["preds"]]),
               rows64=row_distance(out, ref64["out"].numpy()))
    if group is None:
        res["largest"] = largest_allocation(runner, images)
        torch.save(dict(preds=[p.cpu() for p in preds], out=torch.from_numpy(out)),
                   Path(ref_dir) / f"{name}_{str(dtype)[6:]}.pt")
    else:
        ref = torch.load(Path(ref_dir) / f"{name}_{str(dtype)[6:]}.pt")
        res.update(exchange=dict(runner.exchange), strip=runner.spatial.index, out=out,
                   vs_one=level_errors(preds, [r.cuda() for r in ref["preds"]]),
                   rows_one=row_distance(out, ref["out"].numpy()))
    del runner, preds
    torch.cuda.empty_cache()
    return res


def sp_ranks(group, jobs: list, ready: str) -> list:
    torch.zeros(1, device="cuda")  # CUDA's init, while the references are made
    await_refs(ready)
    return [sp_job(group, **job) for job in jobs]


def rows_read(py: torch.Tensor, H: int) -> int:
    """Rows of an H-row map that bilinear samples at rows `py` touch: from
    the lowest point's top corner row to the highest one's bottom corner
    row, clipped to the map."""
    y0 = py.floor()
    return int((y0.max() + 1).clamp(0, H - 1)) - int(y0.min().clamp(0, H - 1)) + 1


def check_row0(gen: torch.Generator) -> dict:
    """dcnv2_im2col and dcnv3_core on the second strip's output rows (row0 =
    half the rows) of yolo-somi-dcn's sites at SP_BATCH x 640 px, as a
    sharded forward calls them: against their plain versions at row0
    (DCN_TOL), bitwise against the whole call's rows and, in f32, against
    grid_sample at the strip's points; the strip call timed beside the
    whole call and grid_sample, and bounded by the map rows its points
    touch. Returns each kernel's bf16 summary of the strip call, sites
    times their launches."""
    v2_sites, v3_sites = dcn_sites("yolo-somi-dcn", SP_BATCH, 640)
    sums = {"dcnv2_im2col": new_summary(), "dcnv3_core": new_summary()}
    for row, count, xs, k, s, p in v2_sites:
        N, H, W, C = xs
        Ho, Wo, P = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1, k * k
        row0 = Ho // 2
        x32 = torch.randn(xs, device="cuda", generator=gen)
        oy32, ox32 = ((torch.rand((2, N, Ho, Wo, P), device="cuda", generator=gen) - 0.5) * 8).unbind(0)
        m32 = torch.sigmoid(torch.randn((N, Ho, Wo, P), device="cuda", generator=gen))
        for dtype in (torch.float32, torch.bfloat16):
            x, oy, ox, m = (t.to(dtype).contiguous() for t in (x32, oy32, ox32, m32))
            part = [t[:, row0:].contiguous() for t in (oy, ox, m)]
            whole = dcnv2_im2col(x, oy, ox, m, k, s, p).view(N, Ho, Wo, -1)
            got = dcnv2_im2col(x, *part, k, s, p, row0=row0)
            torch.cuda.synchronize()
            ref = dcnv2_im2col_reference(x.float(), *(t.float() for t in part), k, s, p, row0=row0)
            err = (got.float() - ref).abs().max().item()
            torch.testing.assert_close(got.float(), ref, **DCN_TOL[dtype])
            assert torch.equal(got.view(N, Ho - row0, Wo, -1), whole[:, row0:]), f"dcnv2_im2col row {row} row0"
            py = (torch.arange(row0, Ho, device="cuda") * s - p)[None, :, None, None] + torch.arange(
                k, device="cuda").repeat_interleave(k) + part[0].float()
            px = (torch.arange(Wo, device="cuda") * s - p)[None, None, :, None] + torch.arange(
                k, device="cuda").repeat(k) + part[1].float()
            # the library call: grid_sample over the strip's points of the whole map, as phase 3 times it
            xin = x.permute(0, 3, 1, 2).contiguous()
            grid = grid_of(px, py, H, W, dtype).reshape(N, (Ho - row0) * Wo, P, 2)
            library = lambda: F.grid_sample(xin, grid, mode="bilinear", padding_mode="zeros",  # noqa: E731
                                            align_corners=False)
            if dtype == torch.float32:  # an independent check of the strip's sampling points
                alt = (library() * part[2].reshape(N, 1, -1, P)).permute(0, 2, 3, 1).reshape(got.shape)
                torch.testing.assert_close(got, alt, **DCN_TOL[dtype])
            kernel_ms = time_ms(lambda: dcnv2_im2col(x, *part, k, s, p, row0=row0))
            whole_ms = time_ms(lambda: dcnv2_im2col(x, oy, ox, m, k, s, p))
            plain_ms = time_ms(lambda: dcnv2_im2col_reference(x, *part, k, s, p, row0=row0))
            library_ms = time_ms(library)
            nbytes = (N * rows_read(py, H) * W * C + 3 * part[0].numel() + got.numel()) * x.element_size()
            bound = roofline(nbytes, 2.0 * C * valid_corners(px, py, H, W), PEAK_FLOPS[torch.float32])
            print(f"row0 dcnv2_im2col row {row} x{tuple(xs)} output rows {row0}..{Ho - 1} of {Ho} {str(dtype)[6:]}: "
                  f"kernel_ms {kernel_ms:.4f} (whole map's rows {whole_ms:.4f}) plain_ms {plain_ms:.4f} "
                  f"library_ms {library_ms:.4f} (grid_sample, sampling only) bound_ms {bound[0]:.4f} ({bound[1]}; "
                  f"x rows {rows_read(py, H)} of {H}) max_abs_err {err:.3e}; bitwise the whole call's rows")
            if dtype == torch.bfloat16:
                add_site(sums["dcnv2_im2col"], count, kernel_ms, plain_ms, library_ms, bound, err)
                sums["dcnv2_im2col"]["whole_ms"] = sums["dcnv2_im2col"].get("whole_ms", 0.0) + count * whole_ms
    for site in v3_sites:
        row, count = site[:2]
        d = dcnv3_site(site, gen)
        N, H, W, G, Cg, Ho, Wo, P = d["shape"]
        row0, args = Ho // 2, d["args"]
        for dtype in (torch.float32, torch.bfloat16):
            v, o, m = (d[key].to(dtype).contiguous() for key in ("v32", "o32", "m32"))
            po, pm = o[:, row0:].contiguous(), m[:, row0:].contiguous()
            whole = dcnv3_core(v, o, m, *args)
            got = dcnv3_core(v, po, pm, *args, row0=row0)
            torch.cuda.synchronize()
            ref = dcnv3_core_reference(v.float(), po.float(), pm.float(), *args, row0=row0)
            err = (got.float() - ref).abs().max().item()
            torch.testing.assert_close(got.float(), ref, **DCN_TOL[dtype])
            assert torch.equal(got, whole[:, row0:]), f"dcnv3_core row {row} row0"
            px, py = d["px"][:, row0:], d["py"][:, row0:]
            vin = v.reshape(N, H, W, G, Cg).permute(0, 3, 4, 1, 2).reshape(N * G, Cg, H, W).contiguous()
            grid = grid_of(px, py, H, W, dtype).permute(0, 3, 1, 2, 4, 5).reshape(N * G, (Ho - row0) * Wo, P, 2)
            library = lambda: F.grid_sample(vin, grid, mode="bilinear", padding_mode="zeros",  # noqa: E731
                                            align_corners=False)
            if dtype == torch.float32:  # an independent check of the strip's sampling points
                mg = pm.reshape(N, -1, G, P).permute(0, 2, 1, 3).reshape(N * G, 1, -1, P)
                alt = (library() * mg).sum(-1).reshape(N, G, Cg, Ho - row0, Wo).permute(0, 3, 4, 1, 2)
                torch.testing.assert_close(got, alt.reshape(got.shape), **DCN_TOL[dtype])
            kernel_ms = time_ms(lambda: dcnv3_core(v, po, pm, *args, row0=row0))
            whole_ms = time_ms(lambda: dcnv3_core(v, o, m, *args))
            plain_ms = time_ms(lambda: dcnv3_core_reference(v, po, pm, *args, row0=row0))
            library_ms = time_ms(library)
            nbytes = (N * rows_read(py, H) * W * G * Cg + po.numel() + pm.numel() + got.numel()) * v.element_size()
            bound = roofline(nbytes, 2.0 * Cg * valid_corners(px, py, H, W), PEAK_FLOPS[torch.float32])
            print(f"row0 dcnv3_core row {row} x{tuple(site[2])} output rows {row0}..{Ho - 1} of {Ho} "
                  f"{str(dtype)[6:]}: kernel_ms {kernel_ms:.4f} (whole map's rows {whole_ms:.4f}) plain_ms "
                  f"{plain_ms:.4f} library_ms {library_ms:.4f} (grid_sample, sampling only) bound_ms "
                  f"{bound[0]:.4f} ({bound[1]}; value rows {rows_read(py, H)} of {H}) max_abs_err {err:.3e}; "
                  "bitwise the whole call's rows")
            if dtype == torch.bfloat16:
                add_site(sums["dcnv3_core"], count, kernel_ms, plain_ms, library_ms, bound, err)
                sums["dcnv3_core"]["whole_ms"] = sums["dcnv3_core"].get("whole_ms", 0.0) + count * whole_ms
    return sums


def spatial_sharding(gpu: str) -> dict:
    """Phase 14: check_row0, and odconv_s2 against its plain version on
    the strips a sharded forward gives it (check_kernel's tolerances); then
    for each config the float64 yardstick
    (sp_ref64) and each SP_JOBS job in one process, then the jobs on
    SP_WORLD gloo ranks sharing cuda:0 (spawn_local, started beside the
    one-process jobs: beside_ranks), each rank holding one
    H-strip of the batch: every rank's launches per forward PER_BATCH, the
    ranks' rows the same bits, and in f32 and bf16 alike the sharded head
    maps no further from the yardstick than SP_RULE times the unsharded
    model's (plus SP_FLOOR); in f32 the rows too (SP_RULE's comment).
    Prints per-rank peak memory, batch time and all-reduced bytes beside
    one process's, and every job before any check can fail. Returns rank
    0's launches per job and the row0 summaries."""
    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # as main() sets it: the phase run alone compares in full f32
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(14)
    row0 = check_row0(gen)
    for cfg_name, size in dict.fromkeys((c, z) for c, _, z in SP_JOBS):  # the kernel on the strips it is given
        check_kernel(odconv_strip_sites(cfg_name, size), gen, f"{cfg_name} strip of {size} px")
    t_row0 = time.perf_counter() - t_phase
    with tempfile.TemporaryDirectory() as tmp:
        jobs = [dict(cfg_name=cfg_name, dtype=dtype, size=size, ref_dir=tmp) for cfg_name, dtype, size in SP_JOBS]

        def one_process():
            for cfg_name, size in dict.fromkeys((c, z) for c, _, z in SP_JOBS):
                sp_ref64(cfg_name, size, tmp)
            return [sp_job(None, **job) for job in jobs]

        refs, per_rank, t_spawned, t_refs = beside_ranks(SP_WORLD, sp_ranks, (jobs,), one_process, Path(tmp))
    launches, failed = {}, []
    for job, ref, ranks in zip(jobs, refs, zip(*per_rank)):
        cfg_name, dtype, size = job["cfg_name"], job["dtype"], job["size"]
        title = f"{cfg_name} {str(dtype)[6:]}"
        want = only(**PER_BATCH[cfg_name])
        r0 = ranks[0]
        limits = [SP_RULE * e + SP_FLOOR * m for e, m in ref["vs64"]]
        maps_ok = all(r["vs64"][i][0] <= lim for r in ranks for i, lim in enumerate(limits))
        u = ref["rows64"]
        rows_ok = dtype != torch.float32 or all(
            r["rows64"]["unmatched"] == u["unmatched"]
            and r["rows64"]["box"] <= SP_RULE * u["box"] + SP_BOX_FLOOR * size
            and r["rows64"]["score"] <= SP_RULE * u["score"] + SP_FLOOR and r["kept"] == ref["kept"] > 0
            for r in ranks)
        ex = r0["exchange"]
        print(f"spatial {title} on {gpu}: b{SP_BATCH} at {size}x{size} px over {SP_WORLD} H-strips (gloo ranks on "
              f"cuda:0) against one process, both against the float64 model: head maps' largest distance by level "
              f"{['%.3e' % e for e, _ in r0['vs64']]} (one process {['%.3e' % e for e, _ in ref['vs64']]}; largest "
              f"|value| {['%.3e' % m for _, m in ref['vs64']]}), from one process's "
              f"{['%.3e' % e for e, _ in r0['vs_one']]}"
              f"; rows kept at conf {SP_CONF} {r0['kept']} (one process {ref['kept']}), from the float64 rows "
              f"{r0['rows64']} (one process {u}), from one process's {r0['rows_one']}; peak memory above the model's "
              f"{r0['model_bytes'] / 1e6:.1f} MB: rank 0 {r0['peak'] / 1e6:.1f} MB, rank 1 "
              f"{ranks[1]['peak'] / 1e6:.1f} "
              f"MB, one process {ref['peak'] / 1e6:.1f} MB (its largest allocation {ref['largest'][0]:.1f} MB by "
              f"{ref['largest'][1]}); batch time rank 0 "
              f"{['%.1f ms' % (t * 1e3) for t in r0['times']]}, one process "
              f"{['%.1f ms' % (t * 1e3) for t in ref['times']]}; all-reduced a batch per rank: halo "
              f"{ex['halo_bytes'] / 1e6:.2f} MB, gather (DCN maps, EMA profiles) {ex['gather_bytes'] / 1e6:.2f} MB, "
              f"whole-map reductions {ex['reduce_bytes'] / 1e6:.3f} MB, head maps {ex['output_bytes'] / 1e6:.2f} MB "
              f"in {ex['calls']} all-reduces; launches per rank {r0['launches']}")
        checks = {"launches": ref["launches"] == want and all(r["launches"] == want for r in ranks),
                  "strips": [r["strip"] for r in ranks] == list(range(SP_WORLD)),
                  "same rows on every rank": all(np.array_equal(r["out"], r0["out"]) for r in ranks),
                  "head maps": maps_ok, "rows": rows_ok}
        failed += [f"{title}: {k}" for k, ok in checks.items() if not ok]
        launches[title] = r0["launches"]
    print(f"spatial sharding on {gpu}: phase 14 {time.perf_counter() - t_phase:.1f} s (kernel checks {t_row0:.1f} s, "
          f"ranks {t_spawned:.1f} s from their spawn, beside one process's jobs {t_refs:.1f} s)")
    assert not failed, failed
    return dict(launches=launches, row0=row0)

# ---------------------------------------------------------------------------
# phase 15: test-time augmentation, and detect's second-stage classifier
# ---------------------------------------------------------------------------

TTA_CANVASES = tuple(math.ceil(IMGSZ * r / 32) * 32 for r in TTA_SCALES[1:])  # the 0.83 and 0.67 passes': 544, 448
# launches per TTA batch: three forwards
TTA_PER_BATCH = {name: {k: 3 * n for k, n in PER_BATCH[name].items()} for name in ("yolo-somi", "yolo-somi-dcn")}
TTA_REQUESTS = 5  # timed TTA batches (and plain ones beside them) a config
TTA_DETECT_IMAGES = 4  # phase 7's first JPEGs (1920x1080 drone frames)
CLASSIFIER = "classifier"  # configs/models/classifier.yaml: a headless graph with a Classify tail (nc 2)


def decode64(preds: list, meta) -> torch.Tensor:
    """models.heads.decode in float64 (the port's decode rounds to f32):
    the yardstick's decoded rows."""
    anchors = torch.as_tensor(meta.anchors_px, dtype=torch.float64, device=preds[0].device)
    rows = []
    for p, a, s in zip(preds, anchors, meta.strides):
        y = torch.sigmoid(p.double())
        rows.append(torch.cat([_grid_boxes(y, a, float(s)), y[..., 4:]], -1).reshape(p.shape[0], -1, p.shape[-1]))
    return torch.cat(rows, 1)


def tta_kernels(meta, gen: torch.Generator) -> dict:
    """The kernels at the sites of the TTA canvases (b8): odconv_s2 at the
    flagship's four, dcnv2_im2col and dcnv3_core at yolo-somi-dcn's, each
    against its plain version (check_kernel's, check_dcnv2's and
    check_dcnv3's tolerances) with kernel, plain, library and bound times."""
    out = {}
    for side in TTA_CANVASES:
        v2, v3 = dcn_sites("yolo-somi-dcn", BATCH, side)
        out[side] = {"odconv_s2": check_kernel(odconv_sites(meta, BATCH, side), gen, f"yolo-somi TTA canvas {side}"),
                     "dcnv2_im2col": check_dcnv2(v2, gen), "dcnv3_core": check_dcnv3(v3, gen)}
    return out


def tta_serve(gpu: str, cfg_name: str) -> dict:
    """TTA_REQUESTS b8 bf16 batches with augment=True (conf 0.25, seed 0,
    DCN offset heads randomised), each image answered, the kernels
    launched TTA_PER_BATCH a batch with the counts set to 0 just before;
    timed beside as many plain batches of the same Runner. Returns this
    path's launch counts."""
    runner = Runner(cfg_name, dtype=torch.bfloat16, imgsz=IMGSZ, device="cuda", seed=0)
    randomize_offset_heads(runner.model, seed=0)
    rng = np.random.default_rng(15)
    batches = [rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8) for _ in range(TTA_REQUESTS + 1)]
    runner(batches[0], augment=True)  # warm-up: cuDNN plans of the 544 and 448 canvases
    runner(batches[0])
    torch.cuda.synchronize()
    reset_counts()
    lat = []
    for images in batches[1:]:
        t0 = time.perf_counter()
        out = runner(images, augment=True)
        lat.append(time.perf_counter() - t0)
        assert out.shape == (BATCH, 300, 6) and np.isfinite(out).all(), out.shape
        assert (out[..., 4] > 0).any(1).all(), f"{cfg_name}: a TTA image without detections"
    launches = launch_counts()
    assert launches == only(**{k: n * TTA_REQUESTS for k, n in TTA_PER_BATCH[cfg_name].items()}), launches
    plain = []
    for images in batches[1:]:
        t0 = time.perf_counter()
        runner(images)
        plain.append(time.perf_counter() - t0)
    med, med_plain = statistics.median(lat), statistics.median(plain)
    per = ", ".join(f"{name} {n // TTA_REQUESTS}/batch" for name, n in launches.items() if n)
    print(f"tta serving {cfg_name} {IMGSZ} px (canvases {IMGSZ}, {TTA_CANVASES[0]} flipped, {TTA_CANVASES[1]}) bf16 "
          f"conf 0.25 "
          f"b{BATCH}, {TTA_REQUESTS} requests on {gpu}: latency median {med * 1e3:.2f} ms/batch (min "
          f"{min(lat) * 1e3:.2f}, max {max(lat) * 1e3:.2f}), {BATCH / med:.1f} img/s; plain batches of the same "
          f"Runner {med_plain * 1e3:.2f} ms/batch, {BATCH / med_plain:.1f} img/s ({med / med_plain:.2f}x); "
          f"detections/img {(out[..., 4] > 0).sum(1).mean():.1f}; launches {per}")
    return launches


def tta_parity(cfg_name: str) -> None:
    """TTA's decoded rows (before NMS) of a b2 batch in f32 through the
    kernels and under plain_version(), each held against the model in
    float64 under plain_version() through the same TTA (decode64): phase
    5's rule, the kernels' rows no further from float64 than twice the
    plain f32 rows plus 1e-6."""
    runner = Runner(cfg_name, dtype=torch.float32, imgsz=IMGSZ, device="cuda", seed=0)
    randomize_offset_heads(runner.model, seed=0)
    images = np.random.default_rng(16).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    x = runner.upload(images)
    reset_counts()
    rows = runner.augment_rows(x)
    assert launch_counts() == only(**TTA_PER_BATCH[cfg_name]), launch_counts()
    with plain_version(), torch.inference_mode():
        ref = runner.augment_rows(x)
        model64 = copy.deepcopy(runner.model).double()
        ref64 = forward_augment(lambda xi: decode64(model64(xi), runner.meta), x.double(), runner.meta.nl,
                                gs=runner.stride)
    assert rows.shape == ref.shape == ref64.shape and torch.isfinite(rows).all(), (rows.shape, ref64.shape)
    for what, cols in (("boxes (px)", slice(0, 4)), ("scores", slice(4, None))):
        k_err = (rows[..., cols].double() - ref64[..., cols]).abs().max().item()
        p_err = (ref[..., cols].double() - ref64[..., cols]).abs().max().item()
        diff = (rows[..., cols] - ref[..., cols]).abs().max().item()
        print(f"tta parity {cfg_name} {what}: {rows.shape[1]} rows an image, kernel-vs-plain {diff:.3e}, vs f64: "
              f"kernel {k_err:.3e} plain {p_err:.3e}")
        assert k_err <= 2 * p_err + 1e-6, (cfg_name, what, k_err, p_err)


def tta_eval(gpu: str, workdir: Path) -> tuple:
    """val.run(augment=True) of the full-width flagship in f32 (head
    tempered as phase 6 tempers it) on phase 6's self-labelled set, through
    the kernels and under plain_version(): mAP@.5 within 0.01, odconv_s2
    12 launches a batch and none under plain_version(). Returns the
    kernels' results."""
    root = workdir / "ds"
    runner = Runner("yolo-somi", nc=10, dtype=torch.float32, imgsz=IMGSZ, device="cuda", seed=0)
    temper_head(runner.model, HEAD_TEMPER)
    loader = DataLoader(DetectionDataset(str(root / "images"), img_size=IMGSZ), BATCH)
    kw = dict(data=str(root / "data.yaml"), batch_size=BATCH, imgsz=IMGSZ, project=str(workdir / "runs"),
              exist_ok=True, dataloader=loader, runner=runner, augment=True)
    results = {}
    for name, ctx in (("tta-f32-kernels", contextlib.nullcontext()), ("tta-f32-plain", plain_version())):
        reset_counts()
        t0 = time.perf_counter()
        with ctx:
            res, _, speed = val.run(name=name, **kw)
        wall = time.perf_counter() - t0
        results[name] = (res, launch_counts())
        print(f"eval yolo-somi {name}: P {res[0]:.5f} R {res[1]:.5f} mAP@.5 {res[2]:.5f} mAP@.5:.95 {res[3]:.5f}; "
              f"Speed {speed[1]:.2f} ms inference+NMS per image; {EVAL_IMAGES / wall:.1f} img/s ({wall:.2f} s); "
              f"launches {results[name][1]}")
    (kernels, launches), (plain, plain_launches) = results.values()
    n_batches = -(-EVAL_IMAGES // BATCH)
    assert launches == only(**{k: n * n_batches for k, n in TTA_PER_BATCH["yolo-somi"].items()}), launches
    assert not any(plain_launches.values()), plain_launches
    assert abs(kernels[2] - plain[2]) <= 0.01, (kernels[2], plain[2])
    return kernels


def tta_detect(gpu: str, src: Path, tmp: Path) -> None:
    """detect.run(augment=True) of the seed-0 flagship (bf16) on phase 7's
    first TTA_DETECT_IMAGES JPEGs: odconv_s2 12 launches an image, and the
    label rows those of Runner(augment=True) on the letterboxed images,
    mapped back, to the printed digits."""
    reset_counts()
    run_dir = detect.run(weights=None, cfg="yolo-somi", source=str(src), imgsz=IMGSZ, save_txt=True, save_conf=True,
                         nosave=True, augment=True, project=str(tmp / "runs"), name="detect-tta", device="cuda")
    launches = launch_counts()
    assert launches == only(odconv_s2=TTA_PER_BATCH["yolo-somi"]["odconv_s2"] * TTA_DETECT_IMAGES), launches
    runner = Runner("yolo-somi", dtype=torch.bfloat16, imgsz=IMGSZ, device="cuda", seed=0)
    n_rows = 0
    for path, img, im0, _ in LoadImages(str(src), img_size=IMGSZ, stride=runner.stride):
        det = runner(img[None], conf_thres=0.4, iou_thres=0.2, augment=True)[0]
        det = det[det[:, 4] > 0]
        det[:, :4] = scale_coords(img.shape[:2], det[:, :4], im0.shape[:2])
        want = [detect.label_line(int(c), xyxy, im0.shape, conf) for *xyxy, conf, c in det]
        label = run_dir / "labels" / f"{Path(path).stem}.txt"
        assert (label.read_text().splitlines() if label.exists() else []) == want, path
        n_rows += len(want)
    assert n_rows > 0, "no rows: the detect check would be vacuous"
    print(f"detect --augment on {gpu}: {TTA_DETECT_IMAGES} JPEGs of {DETECT_IMAGES[0][2]}x{DETECT_IMAGES[0][1]}, "
          f"{n_rows} label rows equal to "
          f"Runner(augment=True)'s; odconv_s2 {launches['odconv_s2']} launches")


def classify_detect(gpu: str, src: Path, tmp: Path) -> None:
    """detect.run(classify="classifier") of the seed-0 flagship on the same
    JPEGs: the classifier (classifier.yaml at its published width, random
    weights from seed 0, a Runner at 224 px) gives finite (N, 2) logits
    for the crops, and the rows kept are a subset of the unfiltered rows."""
    logits = []

    class Recording(Runner):
        def __call__(self, images, **kw):
            out = super().__call__(images, **kw)
            logits.append(out)
            return out

    def labels(name: str, classify=None) -> Counter:
        """The label rows by (file, row), counted: rows repeat at the printed digits."""
        run_dir = detect.run(weights=None, cfg="yolo-somi", source=str(src), imgsz=IMGSZ, save_txt=True, nosave=True,
                             classify=classify, project=str(tmp / "runs"), name=name, device="cuda")
        return Counter((p.name, r) for p in (run_dir / "labels").glob("*.txt") for r in p.read_text().splitlines())

    every = labels("detect-all")
    detect.Runner = Recording
    try:
        kept = labels("detect-classify", CLASSIFIER)
    finally:
        detect.Runner = Runner
    n_crops = sum(len(lg) for lg in logits)
    assert logits and all(lg.ndim == 2 and lg.shape[1] == 2 and np.isfinite(lg).all() for lg in logits), logits
    assert n_crops == every.total() and kept <= every, (n_crops, every.total(), (kept - every).total())
    print(f"detect --classify {CLASSIFIER} on {gpu}: {n_crops} crops classified at 224 px in {len(logits)} calls, "
          f"logits finite, |logit| max {max(np.abs(lg).max() for lg in logits):.3f}; {kept.total()} of "
          f"{every.total()} rows kept, all among the unfiltered rows")


def tta_phase(gpu: str, meta, workdir: Path) -> dict:
    """Phase 15: the TTA kernel checks, TTA serving of the flagship and
    yolo-somi-dcn, TTA parity in f32, val.run and detect.run with augment,
    and detect --classify. Returns the kernel summaries by canvas and the
    TTA serving launches by config."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(15)
    kernels = tta_kernels(meta, gen)
    t_kernels = time.perf_counter() - t_phase
    served = {name: tta_serve(gpu, name) for name in TTA_PER_BATCH}
    for name in TTA_PER_BATCH:
        tta_parity(name)
    tta_eval(gpu, workdir)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        src = tmp / "detect-src"
        src.mkdir()
        rng = np.random.default_rng(0)  # phase 7's first frames
        count, h, w = DETECT_IMAGES[0]
        for i in range(TTA_DETECT_IMAGES):
            assert cv2.imwrite(str(src / f"im{i:02d}_{w}x{h}.jpg"), synthetic_image(rng, h, w))
        tta_detect(gpu, src, tmp)
        classify_detect(gpu, src, tmp)
    print(f"test-time augmentation on {gpu}: phase 15 {time.perf_counter() - t_phase:.1f} s (kernel checks "
          f"{t_kernels:.1f} s)")
    return dict(kernels=kernels, served=served)


# ---------------------------------------------------------------------------
# phase 16: the rest of the detection heads on the flagship's body
# ---------------------------------------------------------------------------

# each head in place of row 35 of configs/models/yolo-somi.yaml (rows 0-34 at
# width 1.0): (input rows, args). IAuxDetect's aux maps are the BiFPN merges
# before each C2f of its levels; CLLADetect and TSCODE_Detect take the P2 map
# (and TSCODE_Detect the P5 map) beside their levels, as their level slices do
HEAD_ROWS = {
    "DetectV8": ([25, 28, 31, 34], ["nc"]),
    "DetectV11": ([25, 28, 31, 34], ["nc"]),
    "IDetect": ([25, 28, 31, 34], ["nc", "anchors"]),
    "IAuxDetect": ([25, 28, 31, 34, 23, 27, 30, 33], ["nc", "anchors"]),
    "ASFF_Detect": ([28, 31, 34], ["nc", "anchors"]),
    "CLLADetect": ([25, 28, 31, 34], ["nc", "anchors"]),
    "TSCODE_Detect": ([25, 28, 31, 34], ["nc", "anchors"]),
    "DetectODConv": ([25, 28, 31, 34], ["nc", "anchors"]),
    "Segment": ([25, 28, 31, 34], ["nc", "anchors", 32, 256]),
    "RTDETRDecoder": ([28, 31, 34], ["nc", 256, 300]),
}
HEAD_STEPS = 5  # timed bf16 b8 train steps of flagship+DetectV8


@torch.no_grad()
def dfl_prior(model: torch.nn.Module, meta) -> None:
    """temper_head for the DFL heads: each level's two output convs' weights
    scaled by HEAD_TEMPER, and the ultralytics Detect head's bias init
    (box logits 1.0, class logits log(5 / nc / (640 / s)^2)), which the JAX
    package's init_model does not apply to them (it sets priors on `m<i>`
    convs only). From JAX's init the class logits spread over +-200 and
    ComputeLossV8's class term sums over every anchor and class (~9e3 at
    640 px, b8): hyp.visdrone's bias warm-up then throws the weights to
    ~1e8 by the second step (NVIDIA H100 80GB HBM3, 700.00 W)."""
    head = model.model[-1]
    for i, s in enumerate(meta.strides):
        box, cls = getattr(head, f"cv2_{i}_2"), getattr(head, f"cv3_{i}_2")
        box.weight.mul_(HEAD_TEMPER)
        cls.weight.mul_(HEAD_TEMPER)
        box.bias.fill_(1.0)
        cls.bias.fill_(math.log(5 / meta.nc / (640 / s) ** 2))


def head_cfg(name: str) -> dict:
    """The flagship's YAML with `name` in place of its DecoupledDetect row."""
    cfg = dict(load_model_cfg(find_config("yolo-somi")))
    f, args = HEAD_ROWS[name]
    cfg["head"] = cfg["head"][:-1] + [[f, 1, name, args]]
    return cfg


def postprocess(runner: Runner, preds, conf: float):
    """The Runner's serving postprocess of raw outputs, as __call__ picks it."""
    head = runner.meta.head_type
    if head == "RTDETRDecoder":
        return Runner.query_rows(preds, (IMGSZ, IMGSZ), conf, 300)
    if head in ANCHOR_HEADS:
        return fused_postprocess(preds, runner.meta.anchors_px, runner.meta.strides, conf_thres=conf)
    return non_max_suppression(runner.decode(preds), conf_thres=conf)


def head_serve(gpu: str, name: str, path: Path, label: str = None, weights: Path = None) -> dict:
    """Phase 16(a) for one head: HEAD_REQUESTS b8 bf16 batches through Runner
    (conf HUB_CONF: random weights under the priors score below 0.25),
    every image answered, odconv_s2 4 times a batch with the counts set to
    0 just before; the model / postprocess split and the peak memory of
    the batches; then the f32 model
    through the kernels against plain_version() by phase 5's rule (for
    RTDETRDecoder the head's input maps: its top-k query selection turns a
    rounding difference into another query order). Returns the launches
    and the median batch latency (s). Phase 17 serves its graphs through
    it, `label` naming the graph in the printed lines, from the weights
    file `weights` where given (else from seed 0)."""
    label = label or f"heads {name} on the flagship's body"
    t0 = time.perf_counter()
    runner = Runner(str(path), weights and str(weights), dtype=torch.bfloat16, imgsz=IMGSZ, device="cuda", seed=0)
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in runner.model.parameters())
    rng = np.random.default_rng(16)
    batches = [rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8) for _ in range(HEAD_REQUESTS + 1)]
    runner(batches[0], conf_thres=HUB_CONF)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for images in batches[1:]:
        t0 = time.perf_counter()
        out = runner(images, conf_thres=HUB_CONF)
        lat.append(time.perf_counter() - t0)
        assert out.shape == (BATCH, 300, 6) and np.isfinite(out).all(), (name, out.shape)
        assert (out[..., 4] > 0).any(1).all(), f"{name}: an image without detections"
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    assert launches == only(odconv_s2=4 * HEAD_REQUESTS), (name, launches)
    fwd, post = [], []
    for images in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds = runner.forward(images)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        postprocess(runner, preds, HUB_CONF).cpu()
        fwd.append(t1 - t0)
        post.append(time.perf_counter() - t1)
    med = statistics.median(lat)
    print(f"{label} (width 1.0, {n_params / 1e6:.2f} M params, nc 10, strides "
          f"{[int(s) for s in runner.meta.strides]}) 640 px bf16 conf {HUB_CONF:g} b{BATCH}, {HEAD_REQUESTS} requests "
          f"on {gpu}: latency median {med * 1e3:.2f} ms/batch (min {min(lat) * 1e3:.2f}, max {max(lat) * 1e3:.2f}), "
          f"{BATCH / med:.1f} img/s; upload+model median {statistics.median(fwd) * 1e3:.2f} ms, postprocess median "
          f"{statistics.median(post) * 1e3:.2f} ms; peak memory {peak / 1e9:.2f} GB; odconv_s2 "
          f"{launches['odconv_s2'] // HEAD_REQUESTS}/batch; the Runner built in {t_build:.1f} s")
    del runner
    torch.cuda.empty_cache()

    runner = Runner(str(path), weights and str(weights), dtype=torch.float32, imgsz=IMGSZ, device="cuda", seed=0)
    images = np.random.default_rng(1).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    x = runner.upload(images)
    rtdetr = name == "RTDETRDecoder"

    def outputs(model, inp):
        with torch.inference_mode():
            out, feats = model(inp, features=True)
        return list(feats) if rtdetr else [t for t in _leaves(out)]

    reset_counts()
    raw = outputs(runner.model, x)
    assert launch_counts() == only(odconv_s2=4), launch_counts()
    with plain_version():
        ref = outputs(runner.model, x)
        ref64 = outputs(copy.deepcopy(runner.model).double(), x.double())
    errs = []
    for a, b, c in zip(raw, ref, ref64):
        assert a.shape == b.shape == c.shape and torch.isfinite(a).all()
        k_err, p_err = (a.double() - c).abs().max().item(), (b.double() - c).abs().max().item()
        errs.append((k_err, p_err))
        assert k_err <= 2 * p_err + 1e-6, (name, k_err, p_err)
    what = "head input maps" if rtdetr else "outputs"
    print(f"{label.split()[0]} parity {name} f32 b2 ({len(raw)} {what}): max |out| "
          f"{max(c.abs().max().item() for c in ref64):.3e}, vs f64 kernel / plain "
          + ", ".join(f"{k:.2e} / {p:.2e}" for k, p in errs))
    del runner
    torch.cuda.empty_cache()
    return dict(launches=launches, latency=med, peak=peak)


def _leaves(out) -> list:
    """The tensors of a head's output: a list of maps, Segment's (levels,
    proto), RT-DETR's one tensor."""
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _leaves(o)]


def heads_training(gpu: str, root: Path) -> dict:
    """Phase 16(b): flagship+DetectV8 (its class and box biases under
    dfl_prior) through ComputeLossV8 on phase 8's set (the same 64 seed-0
    JPEGs): HEAD_STEPS timed bf16 b8 train steps with
    4 + 4 + 4 kernel launches each, the median step and the peak memory
    (the assigner's dense (B, M, N) tensors: M the loader's padded label
    count); one step profiled (the kernels' device time on this graph);
    the f32 b2 step through the kernels against plain_version()
    (train_step_parity, phase 8(b)'s limits); then one flagship+IAuxDetect
    bf16 b8 step through ComputeLoss's aux branch (its 8 maps), with its
    launches. Returns the per-step launches by graph."""
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    ds = DetectionDataset(str(root / "train" / "images"), img_size=IMGSZ, augment=True, hyp=hyp)
    batches = list(itertools.islice(DataLoader(ds, BATCH, shuffle=True, drop_last=True), HEAD_STEPS + 1))
    runs = {}
    for name in ("DetectV8", "IAuxDetect"):
        model, meta = build_model(head_cfg(name), nc=10, device="cuda", seed=0, compute_dtype=torch.bfloat16)
        if name == "DetectV8":
            dfl_prior(model, meta)
        opt = make_optimizer(hyp, nb=len(batches), epochs=1, batch_size=BATCH)
        state = create_train_state(model, opt)
        seen = []
        if name == "DetectV8":
            base = ComputeLossV8(meta, hyp)
        else:
            base = ComputeLoss(meta, hyp)

        def loss_fn(preds, targets, base=base):
            seen.append(len(preds))
            return base(preds, targets)

        step = make_train_step(loss_fn, opt, amp_dtype=torch.bfloat16)
        images, targets = batches[0][:2]
        step(state, images, targets)  # warm-up: cuDNN plans, allocator
        torch.cuda.synchronize()
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        n = HEAD_STEPS if name == "DetectV8" else 1
        for images, targets, _, _ in batches[1:n + 1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = step(state, images, targets)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            assert bool(m["grads_finite"]) and torch.isfinite(m["loss"]), (name, m)
            losses.append([m[k].item() for k in ("loss", "lbox", "lobj", "lcls")])
        launches = launch_counts()
        assert launches == only(**{k: v * n for k, v in STEP_LAUNCHES["yolo-somi"].items()}), (name, launches)
        assert seen[-1] == (2 * meta.nl if name == "IAuxDetect" else meta.nl), (name, seen)
        peak = torch.cuda.max_memory_allocated()
        m_labels = batches[1][1].shape[1]
        n_anchors = sum((IMGSZ // int(s)) ** 2 for s in meta.strides)
        dense = (f"; the assigner's (B, M, N) f32 tensors: {BATCH} x {m_labels} x {n_anchors} = "
                 f"{BATCH * m_labels * n_anchors * 4 / 1e6:.0f} MB each" if name == "DetectV8" else "")
        runs[name] = {k: v // n for k, v in launches.items() if v}
        print(f"heads train {name} (flagship body, {type(base).__name__}) bf16 b{BATCH} {IMGSZ} px on {gpu}: "
              f"{n} step(s) median {statistics.median(times) * 1e3:.1f} ms ({BATCH / statistics.median(times):.1f} "
              f"img/s), losses [loss, box, {'dfl' if name == 'DetectV8' else 'obj'}, cls] "
              f"{[[round(v, 4) for v in row] for row in losses]}, maps per loss call {seen[-1]}, launches per step "
              f"{runs[name]}, peak memory {peak / 1e9:.2f} GB{dense}")
        if name == "DetectV8":
            acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
            images, targets = batches[1][:2]
            with torch.profiler.profile(activities=acts) as prof:
                t0 = time.perf_counter()
                step(state, images, targets)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            events = prof.key_averages()
            kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
            busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
            ours = {label: sum(e.self_device_time_total for e in kernels if any(k in e.key for k in keys)) / 1e3
                    for label, keys in PROFILED[:3]}
            path = OUT / "chip_smoke_profile_train_yolo-somi+DetectV8.txt"
            path.write_text(f"{gpu}\n{events.table(sort_by='self_device_time_total', row_limit=50)}\n")
            RECORD["heads step DetectV8"] = statistics.median(times)
            RECORD["heads peak DetectV8"] = peak
            print(f"heads profile DetectV8 train step (one step, profiler on): wall {wall_ms:.1f} ms, device kernels "
                  f"{busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}% busy), "
                  + ", ".join(f"{k} {v:.2f} ms" for k, v in ours.items()) + f"; table in {path}")
        del model, state, step
        torch.cuda.empty_cache()
        if name == "DetectV8":
            train_step_parity(root, "yolo-somi+DetectV8", cfg=head_cfg("DetectV8"), loss_cls=ComputeLossV8,
                              temper=dfl_prior)
    return runs


def heads_phase(gpu: str) -> dict:
    """Phase 16: each head of HEAD_ROWS on the full-width flagship body
    served and held in f32 (a), flagship+DetectV8 and flagship+IAuxDetect
    trained (b). Returns the serving launches per batch and the training
    launches per step by head."""
    t_phase = time.perf_counter()
    OUT.mkdir(exist_ok=True)
    served = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name in HEAD_ROWS:
            path = tmp / f"yolo-somi-{name}.yaml"
            path.write_text(yaml.safe_dump(head_cfg(name)))
            served[name] = head_serve(gpu, name, path)
            RECORD[f"heads serve {name}"] = served[name]["latency"]
        t_a = time.perf_counter()
        root = tmp / "shapes"
        rng = np.random.default_rng(0)  # phase 8's set
        write_shapes_split(root, "train", TRAIN_IMAGES, rng)
        trained = heads_training(gpu, root)
    print(f"heads on {gpu}: phase 16 {time.perf_counter() - t_phase:.1f} s (serving and f32 parity "
          f"{t_a - t_phase:.1f} s)")
    return dict(served={k: v["launches"]["odconv_s2"] // HEAD_REQUESTS for k, v in served.items()}, trained=trained)


# ---------------------------------------------------------------------------
# phase 17: the body zoo's graphs (the parser's remaining kinds, layers.py's
# upsamplers, fusion, space-to-depth, CSP variants and gates)
# ---------------------------------------------------------------------------

ZOO_STEPS = 3  # timed bf16 b8 train steps of each trained graph
ZOO_TRAINED = ("zoo-fusion", "zoo-rfem", "zoo-c3att", "zoo-asf")


def zoo_training(gpu: str, root: Path, name: str) -> dict:
    """Phase 17(b): graph `name` (zoo-fusion: BiFPN_Add2 / 3, MultiSEAM,
    FReLU / AconC / MetaAconC; zoo-rfem: C3RFEM, RFEM, LVCBlock,
    ConvMixer; zoo-c3att: the C3 blocks with attention bottlenecks, CPCA,
    C2fBAM, C2f_DWR, VoVGSCSPCBAM; zoo-asf: BiFusion, BiFPNs, SF, SDI,
    BiFPNSDI, ScalSeq, attention_model, CAM; head tempered) through ComputeLoss on phase 8's set:
    ZOO_STEPS timed bf16 b8 train steps with 4 + 4 + 4 launches each, the
    median step and the peak memory; then the f32 b2 step through the
    kernels against plain_version() (train_step_parity, phase 8(b)'s
    rule). Returns the launches per step."""
    hyp = load_hyp(find_config("hyp.visdrone", "hyps"))
    ds = DetectionDataset(str(root / "train" / "images"), img_size=IMGSZ, augment=True, hyp=hyp)
    batches = list(itertools.islice(DataLoader(ds, BATCH, shuffle=True, drop_last=True), ZOO_STEPS + 1))
    model, meta = build_model(zoo_graph(name), nc=10, device="cuda", seed=0, compute_dtype=torch.bfloat16)
    temper_head(model, HEAD_TEMPER)
    opt = make_optimizer(hyp, nb=len(batches), epochs=1, batch_size=BATCH)
    state = create_train_state(model, opt)
    step = make_train_step(ComputeLoss(meta, hyp), opt, amp_dtype=torch.bfloat16)
    step(state, *batches[0][:2])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    times, losses = [], []
    for images, targets, _, _ in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = step(state, images, targets)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        assert bool(m["grads_finite"]) and torch.isfinite(m["loss"]), m
        losses.append([m[k].item() for k in ("loss", "lbox", "lobj", "lcls")])
    launches = launch_counts()
    assert launches == only(**{k: v * ZOO_STEPS for k, v in STEP_LAUNCHES[name].items()}), launches
    peak = torch.cuda.max_memory_allocated()
    RECORD[f"zoo step {name}"] = statistics.median(times)
    print(f"zoo train {name} (ComputeLoss, head tempered by {HEAD_TEMPER}) bf16 b{BATCH} {IMGSZ} px on {gpu}: "
          f"{ZOO_STEPS} steps median {statistics.median(times) * 1e3:.1f} ms ({BATCH / statistics.median(times):.1f} "
          f"img/s; phase 8's flagship step {RECORD.get('step yolo-somi', float('nan')) * 1e3:.1f} ms), losses "
          f"[loss, box, obj, cls] {[[round(v, 4) for v in row] for row in losses]}, launches per step "
          f"{ {k: v // ZOO_STEPS for k, v in launches.items() if v} }, peak memory {peak / 1e9:.2f} GB")
    del model, state, step
    torch.cuda.empty_cache()
    train_step_parity(root, name, cfg=zoo_graph(name))
    return {k: v // ZOO_STEPS for k, v in launches.items() if v}


def map_sized(cfg: dict) -> bool:
    """Whether a graph has a block that takes the map's size at build
    (MHSA): a Runner from a seed sizes it for min(imgsz, 256), as the JAX
    Runner inits, so such a graph serves at IMGSZ from a weights file made
    at IMGSZ."""
    return any(row[2] == "MHSA" for row in list(cfg["backbone"]) + list(cfg["head"]))


def body_zoo_phase(gpu: str) -> dict:
    """Phase 17: each graph of models/zoo_graphs.py (the full-width
    flagship with the body zoo's rows, nc 10) served and held in f32 (a,
    through head_serve; a graph with MHSA from a weights file built at
    IMGSZ), each of ZOO_TRAINED trained (b). Returns the serving launches
    per batch by graph and the training launches per step by graph."""
    t_phase = time.perf_counter()
    OUT.mkdir(exist_ok=True)
    served = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for name in ZOO_GRAPHS:
            cfg = zoo_graph(name)
            path, weights = tmp / f"{name}.yaml", None
            path.write_text(yaml.safe_dump(cfg))
            if map_sized(cfg):
                weights = tmp / f"{name}.msgpack"
                model, _ = build_model(cfg, nc=10, device="cuda", seed=0, imgsz=IMGSZ)
                save_variables(weights, export_jax_variables(model))
                del model
            served[name] = head_serve(gpu, name, path, label=f"zoo {name}", weights=weights)
            RECORD[f"zoo serve {name}"] = served[name]["latency"]
        t_a = time.perf_counter()
        root = tmp / "shapes"
        write_shapes_split(root, "train", TRAIN_IMAGES, np.random.default_rng(0))  # phase 8's set
        trained = {name: zoo_training(gpu, root, name) for name in ZOO_TRAINED}
    print(f"body zoo on {gpu}: phase 17 {time.perf_counter() - t_phase:.1f} s (serving and f32 parity "
          f"{t_a - t_phase:.1f} s)")
    return dict(served={k: v["launches"]["odconv_s2"] // HEAD_REQUESTS for k, v in served.items()}, trained=trained)


def build_all(later: tuple = ()):
    """One nvcc per source, all started together. Waits for every source
    but those in `later`, which go on building beside the phases that do
    not launch them; the function returned waits for those."""
    def one(source):
        t0 = time.perf_counter()
        lib = build.build(source)
        return lib, time.perf_counter() - t0

    def wait(sources):
        for source in sources:
            lib, secs = futures[source].result()
            print(f"build: {lib.name} in {secs:.1f} s")
            for line in build.BUILD_LOG.get(source, "").splitlines():
                if "registers" in line or "spill" in line or "Compiling entry" in line:
                    print(f"  ptxas: {line.strip()}")

    pool = ThreadPoolExecutor(len(SOURCES))
    futures = {source: pool.submit(one, source) for source in SOURCES}
    pool.shutdown(wait=False)
    wait([source for source in SOURCES if source not in later])
    return lambda: wait([source for source in SOURCES if source in later])


def kernel_entry(name: str, source: str, replaces: str, launches: int, summary: dict) -> dict:
    return {"name": name, "route": "cuda", "source": f"yolosomi_tpu_torch/ops/csrc/{source}", "replaces": replaces,
            "launches": launches, **summary_fields(summary)}


def summary_fields(summary: dict) -> dict:
    """A kernel's summary's numbers, in the kernels line's keys."""
    return {
        "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"],
        "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"],
        "bound_by": "bytes" if summary["t_bytes"] >= summary["t_ops"] else "operations",
        "library_ms": summary["library_ms"],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    gpu = gpu_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {gpu} | torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: f32 comparisons run in full f32")

    t0 = time.perf_counter()
    int8_built = build_all(later=("conv_int8.cu",))  # its nvcc (~60 s) runs beside phases 1-11
    print(f"build: every source but conv_int8.cu in {time.perf_counter() - t0:.1f} s")

    _, meta = parse_model(load_model_cfg(find_config("yolo-somi")))
    _, meta_s = parse_model(load_model_cfg(find_config("yolo-somi-s")))
    gen = torch.Generator(device="cuda").manual_seed(0)
    odconv_summary = check_kernel(odconv_sites(meta, BATCH, IMGSZ), gen)
    s_summary = check_kernel(odconv_sites(meta_s, BATCH, IMGSZ), gen, "yolo-somi-s")
    v2_sites, v3_sites = dcn_sites("yolo-somi-dcn", BATCH, IMGSZ)
    v2_summary = check_dcnv2(v2_sites, gen)
    v3_summary = check_dcnv3(v3_sites, gen)
    dx_summary, dw_summary = check_backward(odconv_sites(meta, BATCH, IMGSZ), gen)
    s_dx_summary, s_dw_summary = check_backward(odconv_sites(meta_s, BATCH, IMGSZ), gen, "yolo-somi-s")
    v2b_summary, v3b_summary = check_dcn_backward(v2_sites, v3_sites, gen)
    t0 = time.perf_counter()
    at_recipe = recipe_kernels(meta, gen)
    print(f"training recipe on {gpu}: phase 10 kernel checks {time.perf_counter() - t0:.1f} s")
    print("per served batch or train step (bf16, sites times launches): " + "; ".join(
        f"{name} kernel_ms {sm['ms']:.4f} plain_ms {sm['plain_ms']:.4f} library_ms {sm['library_ms']:.4f} "
        f"bound_ms {sm['bound_ms']:.4f} x bound {sm['ms'] / sm['bound_ms']:.1f}"
        for name, sm in (("odconv_s2", odconv_summary), ("dcnv2_im2col", v2_summary), ("dcnv3_core", v3_summary),
                         ("odconv_s2_dx", dx_summary), ("odconv_s2_dwmix", dw_summary),
                         ("dcnv2_im2col_bwd", v2b_summary), ("dcnv3_core_bwd", v3b_summary),
                         ("odconv_s2 yolo-somi-s", s_summary), ("odconv_s2_dx yolo-somi-s", s_dx_summary),
                         ("odconv_s2_dwmix yolo-somi-s", s_dw_summary))))

    flagship = serve(gpu, "yolo-somi")
    dcn = serve(gpu, "yolo-somi-dcn")
    t0 = time.perf_counter()
    family = {name: serve(gpu, name) for name in FAMILY_SERVED}
    print(f"serving the family on {gpu}: {len(family)} configs in {time.perf_counter() - t0:.1f} s")
    sweep(gpu)
    for name in PARITY:
        parity(name)
    eval_dir = tempfile.TemporaryDirectory()  # phase 6's flagship set, evaluated again by phases 12 and 15
    try:
        bf16_eval = evaluate(gpu, workdir=Path(eval_dir.name))
        evaluate(gpu, "yolo-somi-dcn")
        evaluate(gpu, "yolo-somi-dcn", offsets="zero")  # where the random offsets' mAP@.5:.95 gap comes from
        entry_points(gpu)
        trained = training(gpu)
        steps = TRAIN_IMAGES // BATCH * (TRAIN_EPOCHS + 1)
        t0 = time.perf_counter()
        int8_built()
        print(f"build: conv_int8.cu joined {time.perf_counter() - t0:.1f} s into phase 12")
        int8_summary, int8_served = int8_phase(gpu, Path(eval_dir.name), bf16_eval)
        parallel = parallelism(gpu)
        sharded = spatial_sharding(gpu)
        tta = tta_phase(gpu, meta, Path(eval_dir.name))
        heads = heads_phase(gpu)
        zoo = body_zoo_phase(gpu)
    finally:
        eval_dir.cleanup()

    kernels = [
        dict(kernel_entry("odconv_s2", "odconv_s2.cu", "yolosomi_tpu/ops/odconv_pallas.py:111",
                          flagship["odconv_s2"], odconv_summary),
             **{"yolo-somi-s": {"launches": family["yolo-somi-s"]["odconv_s2"], **summary_fields(s_summary)}}),
        kernel_entry("dcnv2_im2col", "dcn.cu", "tools/probe_pallas_gather.py:27", dcn["dcnv2_im2col"], v2_summary),
        kernel_entry("dcnv3_core", "dcn.cu", "tools/probe_pallas_gather.py:27", dcn["dcnv3_core"], v3_summary),
        # no Pallas counterpart: they replace XLA's VJP of the batch-grouped vmap conv that JAX trains ODConv with;
        # yolo-somi-s's sites are checked and timed (phase 8a), not trained, so they carry no launch count
        *(dict(kernel_entry(name, "odconv_s2_bwd.cu", "yolosomi_tpu/models/layers.py:874",
                            trained["yolo-somi"][name], summary),
               launches_per_train_step=trained["yolo-somi"][name] // steps,
               **{"yolo-somi-s": summary_fields(s_sum)})
          for name, summary, s_sum in (("odconv_s2_dx", dx_summary, s_dx_summary),
                                       ("odconv_s2_dwmix", dw_summary, s_dw_summary))),
        # no Pallas counterpart either: they replace XLA's VJP of the gathers that JAX trains the DCN variant with
        *(dict(kernel_entry(name, "dcn_bwd.cu", "yolosomi_tpu/ops/dcn.py:34", trained["yolo-somi-dcn"][name], summary),
               launches_per_train_step=trained["yolo-somi-dcn"][name] // steps)
          for name, summary in (("dcnv2_im2col_bwd", v2b_summary), ("dcnv3_core_bwd", v3b_summary))),
        # no Pallas counterpart: it replaces the quantize and XLA's int8 conv_general_dilated of ConvRaw's int8
        # branch; its numbers (the fused entry's, bf16 x) sum the distinct shapes of one served b8 batch times
        # their calls; library_ms (torch._int_mm on the int8 operands) covers the ungrouped shapes only, beside
        # the kernel's time over the same shapes; int8_input_* time and bound the int8-input entry
        dict(kernel_entry("conv_int8", "conv_int8.cu", "yolosomi_tpu/models/layers.py:238",
                          int8_served["conv_int8"], int8_summary),
             launches_per_batch=int8_served["conv_int8"] // N_REQUESTS, shapes=int8_summary["shapes"],
             kernel_ms_where_library=int8_summary["kernel_ms_where_library"],
             library_padded=sorted(set(int8_summary["library_padded"])),
             **{k: int8_summary[k] for k in ("int8_input_ms", "int8_input_bound_ms", "classes")}),
    ]
    for entry in kernels[:-1]:  # phase 10's shapes, bf16, sites times their launches on such a batch or step
        entry["recipe"] = {label: summary_fields(sums[entry["name"]]) for label, sums in at_recipe.items()}
    for entry in kernels:  # phase 13(a): rank 0's launches in each data-parallel job
        per_job = {job: counts[entry["name"]] for job, counts in parallel.items() if counts.get(entry["name"])}
        if per_job:
            entry["data_parallel_launches"] = per_job
        # phase 14: rank 0's launches per sharded forward; the DCN kernels' bf16 numbers on the second strip
        per_job = {job: counts[entry["name"]] for job, counts in sharded["launches"].items()
                   if counts.get(entry["name"])}
        if per_job:
            entry["spatial_launches_per_rank"] = per_job
        if entry["name"] in sharded["row0"]:
            sm = sharded["row0"][entry["name"]]
            entry["row0"] = dict(summary_fields(sm), whole_rows_ms=sm["whole_ms"])
        # phase 15: launches per TTA batch, and the numbers at the 0.83 and 0.67 passes' canvases (b8, bf16)
        per_job = {cfg: counts[entry["name"]] // TTA_REQUESTS for cfg, counts in tta["served"].items()
                   if counts.get(entry["name"])}
        if per_job:
            entry["tta_launches_per_batch"] = per_job
            entry["tta"] = {f"{side} px": summary_fields(sums[entry["name"]]) for side, sums in tta["kernels"].items()}
        # phase 16: launches per served batch of each head on the flagship's body, per train step of the two trained
        if entry["name"] == "odconv_s2":
            entry["heads_launches_per_batch"] = heads["served"]
        per_job = {head: counts[entry["name"]] for head, counts in heads["trained"].items() if counts.get(entry["name"])}
        if per_job:
            entry["heads_launches_per_train_step"] = per_job
        # phase 17: launches per served batch of each body zoo graph, per train step of each trained graph
        if entry["name"] == "odconv_s2":
            entry["zoo_body_launches_per_batch"] = zoo["served"]
        per_job = {g: counts[entry["name"]] for g, counts in zoo["trained"].items() if counts.get(entry["name"])}
        if per_job:
            entry["zoo_body_launches_per_train_step"] = per_job
    print(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
