"""yolosomi_tpu_torch's CUDA kernels against their plain versions, on a GPU.

These tests need a CUDA device and skip without one. The file imports
neither jax nor the JAX package, so it runs on a machine that has only
PyTorch (tests/conftest.py imports jax, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_port_cuda.py -q
"""

import pytest
import torch

from yolosomi_tpu_torch.ops.odconv import odconv_s2, odconv_s2_reference


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the plain version in full f32
    yield torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 22, 38, 24, 72), (2, 16, 16, 8, 128), (1, 12, 20, 128, 256)])
def test_odconv_s2_kernel_matches_plain_version(cuda, dtype, shape):
    """Odd sizes exercise every ragged edge of the 64x64x32 tiles."""
    b, h, w, cin, cout = shape
    x = torch.randn(b, h, w, cin, device="cuda", generator=cuda).to(dtype)
    wmix = (torch.randn(b, 3, 3, cin, cout, device="cuda", generator=cuda) * 0.1).to(dtype)
    before = odconv_s2.launches
    got = odconv_s2(x, wmix)
    torch.cuda.synchronize()
    assert odconv_s2.launches == before + 1
    assert got.dtype == dtype and got.shape == (b, h // 2, w // 2, cout)
    ref = odconv_s2_reference(x.float(), wmix.float())
    # f32: summation order only; bf16: the output rounding (test_odconv_pallas.py:52-54)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 else dict(atol=0.15, rtol=0.03)
    torch.testing.assert_close(got.float(), ref, **tol)


@pytest.mark.cuda
def test_odconv_s2_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.randn(2, 8, 8, 16, device="cuda", generator=cuda)
    wmix = torch.randn(2, 3, 3, 16, 32, device="cuda", generator=cuda)
    with pytest.raises(TypeError):
        odconv_s2(x.half(), wmix.half())
    with pytest.raises(TypeError):
        odconv_s2(x, wmix.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        odconv_s2(x.permute(0, 2, 1, 3), wmix)
    with pytest.raises(ValueError, match="one CUDA device"):
        odconv_s2(x, wmix.cpu())
