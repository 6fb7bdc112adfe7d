"""yolosomi_tpu_torch — the PyTorch/CUDA port of yolosomi_tpu for NVIDIA Hopper.

The JAX package `yolosomi_tpu` stays the reference; this package imports
none of it (and never imports jax). Modules mirror the reference package's
names so each has an obvious counterpart:

- utils/   config loading (model and data YAMLs), logger, image-size and
           run-directory helpers, box helpers, the flax-variables bridge,
           the mAP metrics (metrics.py) and the COCO evaluator (cocoeval.py)
- data/    the val dataset, its label cache and its ordered, wrap-padded
           loader (datasets.py), the letterbox (augment.py)
- models/  flagship blocks (layers.py), the deformable blocks of
           yolo-somi-dcn (dcn.py), DecoupledDetect (heads.py), the YAML
           graph compiler (yolo.py)
- ops/     the CUDA kernels' wrappers beside their plain versions: the
           per-sample ODConv conv (odconv.py, csrc/odconv_s2.cu) and the
           DCNv3/DCNv2 deformable sampling (dcn.py, csrc/dcn.cu); build.py
           (nvcc + ctypes); the `plain_version()` switch (__init__.py); the
           postprocess (nms.py: the serving path's fused_postprocess and
           the eval path's multi-label non_max_suppression)
- engine/  the Runner (serving and eval)
- val.py   the eval entry point: `run` and `python -m yolosomi_tpu_torch.val`

Public functions keep the JAX package's NHWC layout; inside, modules are
NCHW in `torch.channels_last` memory format (NHWC in memory). Entry points
run on CUDA unless the caller passes device="cpu".
"""
