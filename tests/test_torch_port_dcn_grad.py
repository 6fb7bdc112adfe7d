"""The gradient of yolosomi_tpu_torch's deformable sampling against JAX's,
on the CPU: the plain versions of dcnv2_im2col and dcnv3_core, through
their autograd Functions and the CPU side of their backward wrappers,
against jax.vjp of the JAX package's sampling (yolosomi_tpu/ops/dcn.py).

JAX trains the DCN variant through XLA's VJP of its gathers. At an integer
sampling coordinate its |x| has derivative +1 at 0, which makes the
gradient the one-sided derivative over the corners floor(p) and
floor(p) + 1. Every point is an integer at the zero-initialised offset
heads. Each case here holds integer points (zero offsets, or offsets that
are zero or whole numbers at a share of the points), so a port whose
weight has torch's derivative 0 at 0 misses it: at zero offsets every
offset gradient is then exactly 0.

Tolerance: float32 on both sides, the same arithmetic summed in another
order: 1e-5 relative, and 1e-5 of the largest gradient absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_port_common import few_threads  # noqa: F401
from yolosomi_tpu.ops import dcn as jdcn
from yolosomi_tpu_torch.ops import dcn as ops_dcn
from yolosomi_tpu_torch.ops.dcn import (dcnv2_im2col, dcnv2_im2col_bwd, dcnv2_im2col_reference, dcnv3_core,
                                        dcnv3_core_bwd, dcnv3_core_reference)

RTOL = 1e-5


def jax_dcnv2_sampling(x, offset_y, offset_x, mask, k: int, s: int, p: int):
    """The sampling of the JAX package's DCNv2 (yolosomi_tpu/ops/dcn.py:
    209-233, between its offset conv and its weight) as a function of x,
    the offsets and the mask, in the columns' layout (N, Ho*Wo, P*C)."""
    N, H, W, C = x.shape
    _, Hout, Wout, P = offset_y.shape
    ky = jnp.arange(k, dtype=jnp.float32)
    kx = jnp.arange(k, dtype=jnp.float32)
    grid_y = jnp.broadcast_to(ky[:, None], (k, k)).reshape(P)
    grid_x = jnp.broadcast_to(kx[None, :], (k, k)).reshape(P)
    base_y = jnp.arange(Hout, dtype=jnp.float32) * s - p
    base_x = jnp.arange(Wout, dtype=jnp.float32) * s - p
    py = base_y[None, :, None, None] + grid_y[None, None, None, :] + offset_y
    px = base_x[None, None, :, None] + grid_x[None, None, None, :] + offset_x
    Q = Hout * Wout * P
    img = x.astype(jnp.float32).reshape(N, H, W, 1, C)
    sampled = jdcn._bilinear_gather(img, px.reshape(N, Q, 1), py.reshape(N, Q, 1))
    sampled = sampled.reshape(N, Hout, Wout, P, C) * mask[..., None]
    return sampled.reshape(N, Hout * Wout, P * C)


def draw_offsets(rng, shape, case: str) -> np.ndarray:
    """Offsets of a case: "zero"; "integer", whole numbers in [-4, 4] (many
    points off the map); "random", uniform in [-3, 3] with a third of them
    0 and a third whole numbers (fractional and integer points, some past
    the border)."""
    if case == "zero":
        return np.zeros(shape, np.float32)
    if case == "integer":
        return rng.integers(-4, 5, shape).astype(np.float32)
    off = rng.uniform(-3.0, 3.0, shape)
    share = rng.integers(0, 3, shape)
    off = np.where(share == 0, 0.0, np.where(share == 1, np.round(off), off))
    return off.astype(np.float32)


def assert_grads_match(got, want, names):
    for g, w, name in zip(got, want, names):
        w = np.asarray(w)
        assert g is not None and g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=RTOL * np.abs(w).max(), err_msg=name)


def dcnv2_case(case: str, s: int, seed: int):
    rng = np.random.default_rng(seed)
    n, h, w, c, k, p = 2, 7, 6, 4, 3, 1
    ho, wo = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    oy, ox = (draw_offsets(rng, (n, ho, wo, k * k), case) for _ in range(2))
    mask = (1 / (1 + np.exp(-rng.standard_normal((n, ho, wo, k * k))))).astype(np.float32)
    dcols = rng.standard_normal((n, ho * wo, k * k * c)).astype(np.float32)
    return (x, oy, ox, mask), dcols, (k, s, p)


@pytest.mark.parametrize("case", ["zero", "integer", "random"])
@pytest.mark.parametrize("s", [1, 2])
def test_dcnv2_gradient_matches_jax(case, s):
    """x, both offsets and the mask, through Dcnv2Im2colFunction (whose
    backward on the CPU is dcnv2_im2col_bwd's plain version)."""
    inputs, dcols, geom = dcnv2_case(case, s, seed=10 * s + len(case))
    _, vjp = jax.vjp(lambda *a: jax_dcnv2_sampling(*a, *geom), *(jnp.asarray(a) for a in inputs))
    want = vjp(jnp.asarray(dcols))
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    before = dcnv2_im2col_bwd.launches
    got = torch.autograd.grad(dcnv2_im2col(*leaves, *geom), leaves, torch.from_numpy(dcols))
    assert dcnv2_im2col_bwd.launches == before  # the CPU runs the plain version and counts nothing
    assert_grads_match(got, want, ("x", "offset_y", "offset_x", "mask"))
    if case == "zero":  # what torch's abs made of it: every offset gradient 0
        assert all(np.abs(np.asarray(w)).max() > 1 for w in want[1:3])


def dcnv3_case(case: str, k: int, s: int, seed: int):
    rng = np.random.default_rng(seed)
    n, h, w, g, cg, dil = 1, 6, 7, 2, 4, 1
    pad, P = k // 2, k * k
    ho = (h + 2 * pad - (dil * (k - 1) + 1)) // s + 1
    wo = (w + 2 * pad - (dil * (k - 1) + 1)) // s + 1
    value = rng.standard_normal((n, h, w, g * cg)).astype(np.float32)
    offset = draw_offsets(rng, (n, ho, wo, g * P * 2), case)
    logits = rng.standard_normal((n, ho, wo, g, P)) * 2.0
    mask = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)).reshape(n, ho, wo, g * P).astype(np.float32)
    dout = rng.standard_normal((n, ho, wo, g * cg)).astype(np.float32)
    return (value, offset, mask), dout, (k, k, s, s, pad, pad, dil, dil, g, cg)


@pytest.mark.parametrize("case", ["zero", "integer", "random"])
@pytest.mark.parametrize("k,s", [(3, 1), (3, 2), (5, 1)])
def test_dcnv3_gradient_matches_jax(case, k, s):
    """value, offset and mask, through Dcnv3CoreFunction (whose backward on
    the CPU is dcnv3_core_bwd's plain version); kernel 5 has 25 points."""
    inputs, dout, args = dcnv3_case(case, k, s, seed=100 * k + 10 * s + len(case))
    _, vjp = jax.vjp(lambda *a: jdcn.dcnv3_core(*a, *args), *(jnp.asarray(a) for a in inputs))
    want = vjp(jnp.asarray(dout))
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    before = dcnv3_core_bwd.launches
    got = torch.autograd.grad(dcnv3_core(*leaves, *args), leaves, torch.from_numpy(dout))
    assert dcnv3_core_bwd.launches == before
    assert_grads_match(got, want, ("value", "offset", "mask"))
    if case == "zero":
        assert np.abs(np.asarray(want[1])).max() > 1


def abs_form_weight(p, corner):
    """The corner weight as the port wrote it before: torch's abs, whose
    derivative at 0 is 0."""
    return (1.0 - (p - corner).abs()).abs()


@pytest.mark.parametrize("case", ["zero", "integer", "random"])
def test_forward_is_bitwise_that_of_the_abs_form(case, monkeypatch):
    """The repaired weight changes only the derivative: both plain forwards
    give the same bits as with torch's abs, at integer and fractional
    points, in f32 and f64."""
    v2, _, geom2 = dcnv2_case(case, 1, seed=7)
    v3, _, args3 = dcnv3_case(case, 3, 1, seed=8)
    runs = []
    for weight in (ops_dcn._corner_weight, abs_form_weight):
        monkeypatch.setattr(ops_dcn, "_corner_weight", weight)
        outs = []
        for dtype in (torch.float32, torch.float64):
            outs.append(dcnv2_im2col_reference(*(torch.from_numpy(a).to(dtype) for a in v2), *geom2))
            outs.append(dcnv3_core_reference(*(torch.from_numpy(a).to(dtype) for a in v3), *args3))
        runs.append(outs)
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int64 if a.dtype == torch.float64 else torch.int32),
                           b.view(torch.int64 if b.dtype == torch.float64 else torch.int32))


def test_corner_weight_derivative_is_one_sided_at_integers():
    """d/dp of the weights of corners floor(p) and floor(p) + 1 is -1 and +1
    at an integer p, as between integers."""
    for p0 in (-1.0, 0.0, 2.0, 2.25):
        p = torch.tensor(p0, requires_grad=True)
        x0 = torch.floor(p.detach())
        w0, w1 = ops_dcn._corner_weight(p, x0), ops_dcn._corner_weight(p, x0 + 1)
        g0, g1 = (torch.autograd.grad(w, p)[0].item() for w in (w0, w1))
        assert (g0, g1) == (-1.0, 1.0), (p0, g0, g1)
        assert w0.item() + w1.item() == 1.0


def test_backward_wrappers_return_only_what_is_asked():
    """need_x / need_input False leave the input gradient out; the autograd
    Functions hand back a gradient only where an input asks for one."""
    (x, oy, ox, mask), dcols, geom = dcnv2_case("random", 1, seed=3)
    t = [torch.from_numpy(a) for a in (x, oy, ox, mask)]
    full = dcnv2_im2col_bwd(*t, torch.from_numpy(dcols), *geom)
    part = dcnv2_im2col_bwd(*t, torch.from_numpy(dcols), *geom, need_x=False)
    assert part[0] is None and all(torch.equal(a, b) for a, b in zip(full[1:], part[1:]))
    (v, o, m), dout, args = dcnv3_case("random", 3, 1, seed=4)
    t3 = [torch.from_numpy(a) for a in (v, o, m)]
    full3 = dcnv3_core_bwd(*t3, torch.from_numpy(dout), *args)
    part3 = dcnv3_core_bwd(*t3, torch.from_numpy(dout), *args, need_input=False)
    assert part3[0] is None and all(torch.equal(a, b) for a, b in zip(full3[1:], part3[1:]))
    off = t3[1].clone().requires_grad_()
    (dcnv3_core(t3[0], off, t3[2], *args) * torch.from_numpy(dout)).sum().backward()
    assert torch.equal(off.grad, full3[1])
    with pytest.raises(ValueError, match="does not match"):
        dcnv2_im2col_bwd(*t, torch.from_numpy(dcols)[:, 1:], *geom)
    with pytest.raises(ValueError, match="does not match"):
        dcnv3_core_bwd(*t3, torch.from_numpy(dout)[..., 1:], *args)
    with pytest.raises(ValueError, match="CUDA"):  # no plain version off the CPU
        dcnv2_im2col_bwd(*(a.to("meta") for a in t), torch.from_numpy(dcols).to("meta"), *geom)
