"""yolosomi_tpu_torch ODConv against the JAX package: the per-sample conv's
plain version against the Pallas kernel (interpret mode), and the whole
ODConv module against the flax ODConv at the flagship's row 1 and row 26
sites. The CUDA kernel itself is checked on a GPU by
tests/test_torch_port_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_port_common import IMGSZ, jax_flagship, layer_variables, small_flagship_cfg
from yolosomi_tpu.ops.odconv_pallas import odconv_s2_pallas
from yolosomi_tpu_torch.models.yolo import build_model
from yolosomi_tpu_torch.ops.odconv import odconv_s2, odconv_s2_reference, plain_version
from yolosomi_tpu_torch.utils.weights import load_jax_variables


@pytest.mark.parametrize(
    "b,h,w,cin,cout",
    [(2, 16, 16, 8, 128), (2, 8, 8, 32, 256), (2, 8, 8, 128, 256), (1, 12, 20, 16, 128)],
)
def test_reference_matches_pallas_kernel(b, h, w, cin, cout):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wmix = (rng.standard_normal((b, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    ref = np.asarray(odconv_s2_pallas(jnp.asarray(x), jnp.asarray(wmix), interpret=True))
    got = odconv_s2_reference(torch.from_numpy(x), torch.from_numpy(wmix)).numpy()
    assert got.shape == (b, h // 2, w // 2, cout)
    # f32 on both sides: only the summation order differs
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_wrapper_on_cpu_runs_the_plain_version_and_checks_shapes():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 8, 6, 4)).astype(np.float32))
    wmix = torch.from_numpy(rng.standard_normal((2, 3, 3, 4, 5)).astype(np.float32))
    before = odconv_s2.launches
    torch.testing.assert_close(odconv_s2(x, wmix), odconv_s2_reference(x, wmix), rtol=0, atol=0)
    assert odconv_s2.launches == before  # only CUDA launches count
    with pytest.raises(ValueError, match="even"):
        odconv_s2(x[:, :7], wmix)
    with pytest.raises(ValueError, match="does not match"):
        odconv_s2(x, wmix[:, :, :, :3])
    with pytest.raises(ValueError, match="CUDA"):  # no silent plain version off the CPU
        odconv_s2(x.to("meta"), wmix.to("meta"))


@pytest.fixture(scope="module")
def flagship():
    cfg = small_flagship_cfg()
    jmodel, jmeta, variables = jax_flagship(cfg)
    pmodel, _ = build_model(cfg, nc=jmeta.nc, device="cpu")
    assert load_jax_variables(pmodel, variables) == ([], [])
    return jmodel, jmeta, variables, pmodel


@pytest.mark.parametrize("row", [1, 26])
def test_odconv_module_matches_flax(flagship, row):
    """Trunk + K-mix + per-sample conv + bias mix + BN + SiLU."""
    jmodel, jmeta, variables, pmodel = flagship
    spec = jmeta.specs[row]
    src = row + spec.f if spec.f < 0 else spec.f
    c1, hw = jmeta.specs[src].c2, int(IMGSZ / jmeta.specs[src].stride)
    x = np.random.default_rng(row).standard_normal((2, hw, hw, c1)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda v, t: jmodel.layers[row].apply(v, t, False))(layer_variables(variables, row), x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        got = pmodel.model[row](xt).permute(0, 2, 3, 1).numpy()
        with plain_version():  # on the CPU both name the plain version
            same = pmodel.model[row](xt).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape == (2, hw // 2, hw // 2, spec.c2)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got, same)
