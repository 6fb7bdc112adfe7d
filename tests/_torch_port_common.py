"""Shared fixtures for the yolosomi_tpu_torch parity tests: the JAX flagship
at a small size with randomized variables, as nested dicts of numpy arrays
for the port's weight bridge, and seeded numpy draws for any model's flax
variable tree."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_parity import _randomized_state_dict
from yolosomi_tpu.models.yolo import build_model as jax_build_model
from yolosomi_tpu.utils.config import find_config, load_model_cfg
from yolosomi_tpu.utils.torch_convert import convert_state_dict
from yolosomi_tpu.utils.torch_mirror import build_torch_mirror

WIDTH, DEPTH, IMGSZ, NC = 0.25, 0.33, 64, 3


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """torch's CPU ops on one thread in a module that imports this fixture:
    the test run shares the machine among several worker processes, and a
    pool of one thread per core in each of them thrashes (a small model's
    train step took 40x as long with six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_flagship_cfg() -> dict:
    cfg = dict(load_model_cfg(find_config("yolo-somi")))
    cfg["width_multiple"], cfg["depth_multiple"] = WIDTH, DEPTH
    return cfg


def jax_flagship(cfg: dict, nc: int = NC):
    """(flax model, meta, variables as numpy dicts). Variables are randomized
    as tests/test_onnx_export.py does (random torch-mirror state_dict with
    non-trivial BN stats, carried over by convert_state_dict); the variable
    tree's shapes come from eval_shape, so nothing is compiled here."""
    model, meta = jax_build_model(cfg, nc=nc)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False))
    sd = _randomized_state_dict(build_torch_mirror(cfg, meta, imgsz=IMGSZ, decode=False))
    variables = convert_state_dict(sd, shapes, strict=True)
    return model, meta, jax.tree_util.tree_map(np.asarray, jax.device_get(variables))


def layer_variables(variables: dict, i: int) -> dict:
    """The variables of flax submodule layers_<i>."""
    key = f"layers_{i}"
    return {c: variables[c][key] for c in ("params", "batch_stats") if key in variables.get(c, {})}


def random_variables(shapes, seed: int) -> dict:
    """Numpy draws for every leaf of a flax variable tree of shapes."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        names = [str(getattr(p, "key", p)) for p in path]
        name, parent, shape = names[-1], names[-2] if len(names) > 1 else "", leaf.shape
        fan_in = math.prod(shape[:-1]) if len(shape) > 1 else 1
        if names[0] == "batch_stats":
            v = rng.uniform(0.5, 2.5, shape) if name == "var" else 0.2 * rng.standard_normal(shape)
        elif parent == "conv_offset_mask" and name == "bias":  # [dy x P | dx x P | mask x P]
            p = shape[0] // 3
            v = rng.standard_normal(shape) * np.repeat([2.0, 2.0, 1.0], p)
        elif parent in ("conv_offset_mask", "offset", "mask") and name == "kernel":
            v = rng.standard_normal(shape) / math.sqrt(fan_in)
        elif parent in ("offset", "mask"):
            v = rng.standard_normal(shape) * (2.0 if parent == "offset" else 1.0)
        elif parent == "norm" and name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name in ("weight", "w") and len(shape) == 1:  # BiFPN's and BiFPN_Add's fusion weights (ReLU'd)
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = 0.1 * rng.standard_normal(shape)
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _to_dict(tree) -> dict:
    return {k: _to_dict(v) if hasattr(v, "items") else v for k, v in tree.items()}


def jax_random_model(cfg: dict, nc: int = NC, seed: int = 0):
    """(flax model, meta, variables as numpy dicts) for any config, the
    variables drawn by random_variables from the eval_shape tree: the
    torch mirror that jax_flagship randomizes through has no C2f, Contract
    or BottleneckCSP. Nothing is compiled here."""
    model, meta = jax_build_model(cfg, nc=nc)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, IMGSZ, IMGSZ, 3)), train=False))
    return model, meta, _to_dict(random_variables(shapes, seed))


# the blocks of the JAX registry with no dataclass field but dtype: its
# parse_model builds a plain row as `cls(c2, dtype=dtype)`, which fills
# dtype twice and raises TypeError; the port builds them from an empty row
FIELDLESS = ("LSKblock", "TripletAttention", "NonLocalBlock", "DoubleAttention", "ParallelPolarizedSelfAttention",
             "S2Attention", "ELA", "MSCAAttention")


@pytest.fixture(scope="module")
def fieldless_rows():
    """Within a module that uses it, the JAX registry builds the FIELDLESS
    blocks from an empty row as the port does (`cls(dtype=dtype)`); the
    registry is restored after the module."""
    from yolosomi_tpu.models import yolo as jyolo

    def no_field(cls):
        return lambda *args, dtype: cls(dtype=dtype)

    with pytest.MonkeyPatch.context() as mp:
        for name in FIELDLESS:
            cls, kind = jyolo._REGISTRY[name]
            mp.setitem(jyolo._REGISTRY, name, (no_field(cls), kind))
        yield
