"""The DCN gradient kernels under their launch plans, at the DCN sites of
yolo-somi-dcn (b8, 640 px), on one NVIDIA GPU:

    python3 probe_dcn_bwd.py [--parent DIR]

On inputs drawn as chip_smoke.py draws them (offsets of +-4 px, and 0),
it times (cold L2, chip_smoke.time_ms) dcnv2_im2col_bwd at rows 6 and 8
and dcnv3_core_bwd at row 10 as the wrappers call them, in bf16 and f32,
with the share of corners past each plan's windows; in bf16 at random
offsets also under other tiles, channel slices and halos, the plan
ops/dcn.py chooses marked `*`; and the wrapper's zero fill and cast of the
input gradient alone. Every plan's result is held to autograd of the plain
version within chip_smoke.GRAD_TOL, its offset and mask gradients to the
same bits over two calls. With --parent, DIR is another checkout's root
(the kernels before their redesign): its csrc/dcn_bwd.cu is built and
timed in the same process on the same inputs. A diagnostic for the plan
functions; chip_smoke.py holds the planned kernels in the training path.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from chip_smoke import (BATCH, GRAD_TOL, IMGSZ, dcn_sites, dcnv3_site, gpu_line, plan_text, rel_err, same_corners,
                        spill_share, time_ms)
from yolosomi_tpu_torch.ops import build
from yolosomi_tpu_torch.ops.dcn import (_PTR, _INT, _v2_bwd_launch, _v2_bwd_plan, _v3_bwd_launch, _v3_bwd_plan,
                                        _v3_geometry, dcnv2_im2col_backward_reference, dcnv2_im2col_bwd,
                                        dcnv3_core_backward_reference, dcnv3_core_bwd)

TILES, SLICES, HALOS = (4, 8, 16), (64, 128, 256), (1, 2, 4)
# the C signatures of the kernels before their redesign, without the stream
PARENT_ARGTYPES = {"dcnv2_im2col_bwd": [_PTR] * 9 + [_INT] * 11,
                   "dcnv3_core_bwd": [_PTR] * 7 + [_INT] * 15 + [ctypes.c_float] + [_INT] * 2}
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def parent_entries(root: Path) -> dict:
    """The parent's gradient entry points, built from root's dcn_bwd.cu."""
    src = root / "yolosomi_tpu_torch" / "ops" / "csrc" / "dcn_bwd.cu"
    out = build.BUILD_DIR / "parent_dcn_bwd.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    entries = {}
    for name, argtypes in PARENT_ARGTYPES.items():
        for dtype, suffix in _DTYPES.items():
            fn = getattr(lib, f"{name}_{suffix}")
            fn.argtypes, fn.restype = argtypes + [_PTR], ctypes.c_int
            entries[name, dtype] = fn
    return entries


def call(fn, ptrs, ints) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*(t.data_ptr() for t in ptrs), *ints, stream)
    if rc != 0:
        raise RuntimeError(f"parent kernel: CUDA error {rc}")


def parent_v2(fn, x, oy, ox, m, g, k, s, p):
    """The parent's dcnv2_im2col_bwd, as its wrapper called it."""
    N, H, W, C = x.shape
    _, Ho, Wo, _ = oy.shape
    dx = torch.zeros(x.shape, device=x.device, dtype=torch.float32)
    outs = [torch.empty_like(t) for t in (oy, ox, m)]
    vec, lanes = _v3_geometry(C, x.element_size(), x.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0)
    call(fn, (x, oy, ox, m, g, dx, *outs), (N, H, W, C, Ho, Wo, k, s, p, vec, lanes))
    return (dx.to(x.dtype), *outs)


def parent_v3(fn, v, o, m, g, args):
    """The parent's dcnv3_core_bwd, as its wrapper called it."""
    N, H, W, _ = v.shape
    _, Ho, Wo, _ = o.shape
    dv = torch.zeros(v.shape, device=v.device, dtype=torch.float32)
    outs = [torch.empty_like(t) for t in (o, m)]
    vec, lanes = _v3_geometry(args[9], v.element_size(), v.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0)
    call(fn, (v, o, m, g, dv, *outs), (N, H, W, *args[8:], Ho, Wo, *args[:8], 1.0, vec, lanes))
    return (dv.to(v.dtype), *outs)


def held(name, fn, ref, keeps, dtype) -> None:
    """fn's gradients within GRAD_TOL[dtype] of ref, the offset and mask
    ones the same bits over two calls."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    errs = [rel_err(g, r, k) for g, r, k in zip(a, ref, keeps)]
    assert all(e <= GRAD_TOL[dtype] for e in errs), (name, errs)
    assert all(torch.equal(x, y) for x, y in zip(a[1:], b[1:])), (name, "not repeatable")


def plans(make, chosen) -> list:
    """The chosen plan first, then every other (tile, slice, halo)."""
    out = [chosen]
    for tile in TILES:
        for slice_ in SLICES:
            for halo in HALOS:
                plan = make(tile=tile, slice_=slice_, halo=halo)
                if plan not in out:
                    out.append(plan)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_dcn_bwd: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="root of a checkout whose dcn_bwd.cu to time beside this one's")
    opt = ap.parse_args()
    print(gpu_line())
    parent = parent_entries(opt.parent) if opt.parent else {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    v2_sites, v3_sites = dcn_sites("yolo-somi-dcn", BATCH, IMGSZ)
    for row, _, xs, k, s, p in v2_sites:
        N, H, W, C = xs
        Ho, Wo, P = (H + 2 * p - k) // s + 1, (W + 2 * p - k) // s + 1, k * k
        x32 = torch.randn(xs, device="cuda", generator=gen)
        m32 = torch.sigmoid(torch.randn((N, Ho, Wo, P), device="cuda", generator=gen))
        g32 = torch.randn((N, Ho * Wo, P * C), device="cuda", generator=gen)
        rand = ((torch.rand((2, N, Ho, Wo, P), device="cuda", generator=gen) - 0.5) * 8).unbind(0)
        kk = torch.arange(k, device="cuda")
        for offsets, (oy32, ox32) in (("random", rand), ("zero", (torch.zeros_like(m32), torch.zeros_like(m32)))):
            py = (torch.arange(Ho, device="cuda") * s - p)[None, :, None, None] + kk.repeat_interleave(k) + oy32
            px = (torch.arange(Wo, device="cuda") * s - p)[None, None, :, None] + kk.repeat(k) + ox32
            for dtype in (torch.bfloat16, torch.float32):
                x, oy, ox, m, g = (t.to(dtype).contiguous() for t in (x32, oy32, ox32, m32, g32))
                ref = dcnv2_im2col_backward_reference(x.float(), oy.float(), ox.float(), m.float(), g.float(), k, s, p)
                chosen = _v2_bwd_plan(N, C, Ho, Wo, k, s, x.element_size())
                head = f"dcnv2_im2col_bwd row {row} x{tuple(xs)} {str(dtype)[6:]} {offsets} offsets"
                wrapper = lambda: dcnv2_im2col_bwd(x, oy, ox, m, g, k, s, p)  # noqa: E731
                held(head, wrapper, ref, (None,) * 4, dtype)
                line = f"{head}: kernel_ms {time_ms(wrapper):.4f} *{plan_text(chosen)} spill " \
                       f"{spill_share(chosen, px, py, H, W, s, p):.4f}"
                if parent:
                    old = lambda: parent_v2(parent["dcnv2_im2col_bwd", dtype], x, oy, ox, m, g, k, s, p)  # noqa: E731
                    held(head + " parent", old, ref, (None,) * 4, dtype)
                    line += f"; parent_ms {time_ms(old):.4f}"
                fill = lambda: torch.zeros(x.shape, device="cuda", dtype=torch.float32).to(dtype)  # noqa: E731
                print(line + f"; zero fill and cast {time_ms(fill):.4f} ms")
                if dtype != torch.bfloat16 or offsets != "random":
                    continue
                make = lambda **kw: _v2_bwd_plan(N, C, Ho, Wo, k, s, x.element_size(), **kw)  # noqa: E731
                for plan in plans(make, chosen)[1:]:
                    run = lambda: _v2_bwd_launch(x, oy, ox, m, g, k, s, p, plan)  # noqa: E731
                    held(f"{head} {plan}", run, ref, (None,) * 4, dtype)
                    print(f"  {plan_text(plan)} spill {spill_share(plan, px, py, H, W, s, p):.4f}: "
                          f"{time_ms(run):.4f} ms (f32 dx, no cast)")
    for site in v3_sites:
        row, _, xs = site[:3]
        d = dcnv3_site(site, gen)
        N, H, W, G, Cg, Ho, Wo, P = d["shape"]
        args = d["args"]
        g32 = torch.randn((N, Ho, Wo, G * Cg), device="cuda", generator=gen)
        for offsets, o32, px, py in (("random", d["o32"], d["px"], d["py"]),
                                     ("zero", torch.zeros_like(d["o32"]), d["bx"].expand_as(d["px"]),
                                      d["by"].expand_as(d["py"]))):
            for dtype in (torch.bfloat16, torch.float32):
                v, o, m, g = (t.to(dtype).contiguous() for t in (d["v32"], o32, d["m32"], g32))
                ref = dcnv3_core_backward_reference(v.float(), o.float(), m.float(), g.float(), *args)
                keeps = (None, same_corners(o, H, W, args), None)
                chosen = _v3_bwd_plan(N, G, Cg, Ho, Wo, *args[:4], *args[6:8], v.element_size())
                head = f"dcnv3_core_bwd row {row} x{tuple(xs)} G {G} {str(dtype)[6:]} {offsets} offsets"
                wrapper = lambda: dcnv3_core_bwd(v, o, m, g, *args)  # noqa: E731
                held(head, wrapper, ref, keeps, dtype)
                line = f"{head}: kernel_ms {time_ms(wrapper):.4f} *{plan_text(chosen)} spill " \
                       f"{spill_share(chosen, px, py, H, W, args[2], args[4]):.4f}"
                if parent:
                    old = lambda: parent_v3(parent["dcnv3_core_bwd", dtype], v, o, m, g, args)  # noqa: E731
                    held(head + " parent", old, ref, keeps, dtype)
                    line += f"; parent_ms {time_ms(old):.4f}"
                fill = lambda: torch.zeros(v.shape, device="cuda", dtype=torch.float32).to(dtype)  # noqa: E731
                print(line + f"; zero fill and cast {time_ms(fill):.4f} ms")
                if dtype != torch.bfloat16 or offsets != "random":
                    continue
                make = lambda **kw: _v3_bwd_plan(N, G, Cg, Ho, Wo, *args[:4], *args[6:8],  # noqa: E731
                                                 v.element_size(), **kw)
                for plan in plans(make, chosen)[1:]:
                    run = lambda: _v3_bwd_launch(v, o, m, g, args, 1.0, plan)  # noqa: E731
                    held(f"{head} {plan}", run, ref, keeps, dtype)
                    print(f"  {plan_text(plan)} spill {spill_share(plan, px, py, H, W, args[2], args[4]):.4f}: "
                          f"{time_ms(run):.4f} ms (f32 dvalue, no cast)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
