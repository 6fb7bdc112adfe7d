"""yolosomi_tpu_torch — the PyTorch/CUDA port of yolosomi_tpu for NVIDIA Hopper.

The JAX package `yolosomi_tpu` stays the reference; this package imports
none of it (and never imports jax). Modules mirror the reference package's
names so each has an obvious counterpart:

- utils/   config loading, logger, box helpers, the flax-variables bridge
- models/  flagship blocks (layers.py), the deformable blocks of
           yolo-somi-dcn (dcn.py), DecoupledDetect (heads.py), the YAML
           graph compiler (yolo.py)
- ops/     the CUDA kernels' wrappers beside their plain versions: the
           per-sample ODConv conv (odconv.py, csrc/odconv_s2.cu) and the
           DCNv3/DCNv2 deformable sampling (dcn.py, csrc/dcn.cu); build.py
           (nvcc + ctypes); the `plain_version()` switch (__init__.py); the
           serving postprocess (nms.py)
- engine/  the serving Runner

Public functions keep the JAX package's NHWC layout; inside, modules are
NCHW in `torch.channels_last` memory format (NHWC in memory). Entry points
run on CUDA unless the caller passes device="cpu".
"""
