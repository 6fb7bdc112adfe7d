"""yolosomi_tpu_torch — the PyTorch/CUDA port of yolosomi_tpu for NVIDIA Hopper.

The JAX package `yolosomi_tpu` stays the reference; this package imports
none of it (and never imports jax). Modules mirror the reference package's
names so each has an obvious counterpart:

- utils/   config loading, logger, box helpers, the flax-variables bridge
- models/  flagship blocks (layers.py), DecoupledDetect (heads.py), the
           YAML graph compiler (yolo.py)
- ops/     the per-sample ODConv conv (odconv.py: CUDA kernel wrapper and
           its plain version; csrc/odconv_s2.cu; build.py), the serving
           postprocess (nms.py)
- engine/  the serving Runner

Public functions keep the JAX package's NHWC layout; inside, modules are
NCHW in `torch.channels_last` memory format (NHWC in memory). Entry points
run on CUDA unless the caller passes device="cpu".
"""
