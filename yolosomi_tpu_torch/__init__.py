"""yolosomi_tpu_torch — the PyTorch/CUDA port of yolosomi_tpu for NVIDIA Hopper.

The JAX package `yolosomi_tpu` stays the reference; this package imports
none of it (and never imports jax). Modules mirror the reference package's
names so each has an obvious counterpart:

- utils/   config loading (model and data YAMLs), logger, image-size and
           run-directory helpers, box helpers, the flax-variables bridge
           both ways (weights.py), the msgpack codec of flax's checkpoint
           files (msgpack.py), box IoU with CIoU (iou.py), the mAP metrics
           (metrics.py), the COCO evaluator (cocoeval.py) and the
           second-stage classifier filter (classifier.py)
- data/    the val dataset, its label cache and its ordered, wrap-padded
           loader, and the inference sources LoadImages and LoadStreams
           (datasets.py); the letterbox (augment.py)
- models/  the detection family's blocks (layers.py), the deformable
           blocks of yolo-somi-dcn (dcn.py), DecoupledDetect and the
           coupled Detect (heads.py), the YAML graph compiler with its
           anchor presets (yolo.py)
- ops/     the CUDA kernels' wrappers beside their plain versions: the
           per-sample ODConv conv (odconv.py, csrc/odconv_s2.cu) and the
           DCNv3/DCNv2 deformable sampling (dcn.py, csrc/dcn.cu); build.py
           (nvcc + ctypes); the `plain_version()` switch (__init__.py); the
           postprocess (nms.py: the serving path's fused_postprocess, the
           eval path's multi-label non_max_suppression, soft-NMS scores);
           weighted boxes fusion (wbf.py)
- engine/  the Runner (serving and eval), EnsembleRunner and attempt_load
           (runner.py); checkpoint files (checkpoint.py)
- api.py   Detections, AutoShape, `load`
- entry points: `python -m yolosomi_tpu_torch.val` (eval), `.detect`
           (images, directories, globs, videos), `.serve` (the REST
           server), `.wbf` (label fusion); hubconf.py (the hub loaders)

Public functions keep the JAX package's NHWC layout; inside, modules are
NCHW in `torch.channels_last` memory format (NHWC in memory). Entry points
run on CUDA unless the caller passes device="cpu".
"""
