"""Drive the PyTorch/CUDA port (yolosomi_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:
 1. device: needs CUDA; prints the card's name and power limit; TF32 off
 2. build: compiles every CUDA kernel of the serving path from csrc/
 3. kernels: each kernel against its plain PyTorch version at the shapes
    the serving path gives it (f32 and bf16), with kernel, plain-version,
    library-call and bound times
 4. serving: the full-width yolo-somi flagship (640 px, bf16, random
    weights from seed 0) answers batches of 8 uint8 images through
    Runner; every kernel must have launched on this path
 5. parity: the same model in f32 through the kernel is as close to the
    plain version in f64 as the plain version in f32 is, on a batch of 2
The last two lines are the kernel summary and the device JSON. Longer
tables (the profiler's kernel breakdown) go to chiprun_out/.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.models.yolo import parse_model
from yolosomi_tpu_torch.ops import build
from yolosomi_tpu_torch.ops.nms import fused_postprocess
from yolosomi_tpu_torch.ops.odconv import odconv_s2, odconv_s2_reference, plain_version
from yolosomi_tpu_torch.utils.config import find_config, load_model_cfg

IMGSZ = 640
BATCH = 8
N_REQUESTS = 10
# H100 SXM data-sheet peaks (dense): bf16 tensor cores, f32 without them, HBM3
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
OUT = Path("chiprun_out")


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of one call, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def odconv_sites(meta, batch: int, imgsz: int):
    """(row, x shape, wmix shape) of every ODConv row of the graph."""
    sites = []
    for spec in meta.specs:
        if spec.name in ("ODConv", "ODConv_3rd"):
            src = meta.specs[spec.i + spec.f if spec.f < 0 else spec.f]
            hw = int(imgsz / src.stride)
            sites.append((spec.i, (batch, hw, hw, src.c2), (batch, 3, 3, src.c2, spec.c2)))
    return sites


def bound_ms(x: torch.Tensor, wmix: torch.Tensor) -> tuple:
    """Least time for this call: each input read once, the output written
    once, over HBM bandwidth; the conv's FLOPs over the dtype's peak."""
    B, H, W, C = x.shape
    cout = wmix.shape[-1]
    m = (H // 2) * (W // 2)
    nbytes = (x.numel() + wmix.numel() + B * m * cout) * x.element_size()
    flops = 2.0 * B * m * cout * 9 * C
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS[x.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), t_bytes, t_ops


def check_kernel(sites, gen: torch.Generator) -> dict:
    """odconv_s2 against odconv_s2_reference at every site, f32 and bf16."""
    summary = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0, "t_bytes": 0.0, "t_ops": 0.0,
               "max_abs_err": 0.0}
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
            kernel_ms = time_ms(lambda: odconv_s2(x, w))
            plain_ms = time_ms(lambda: odconv_s2_reference(x, w))
            # the library call alone: one grouped conv on inputs already in its layout
            B, H, W, C = x.shape
            cout = w.shape[-1]
            xg = x.permute(0, 3, 1, 2).reshape(1, B * C, H, W).contiguous()
            wg = w.permute(0, 4, 3, 1, 2).reshape(B * cout, C, 3, 3).contiguous()
            library_ms = time_ms(lambda: F.conv2d(xg, wg, stride=2, padding=1, groups=B))
            b_ms, b_by, t_bytes, t_ops = bound_ms(x, w)
            print(f"odconv_s2 row {row} x{tuple(xs)} cout {ws[-1]} {str(dtype)[6:]}: kernel_ms {kernel_ms:.4f} "
                  f"plain_ms {plain_ms:.4f} library_ms {library_ms:.4f} bound_ms {b_ms:.4f} ({b_by}) "
                  f"max_abs_err {err:.3e}")
            if dtype == torch.bfloat16:  # the serving path's dtype
                summary["ms"] += kernel_ms
                summary["plain_ms"] += plain_ms
                summary["library_ms"] += library_ms
                summary["bound_ms"] += b_ms
                summary["t_bytes"] += t_bytes
                summary["t_ops"] += t_ops
                summary["max_abs_err"] = max(summary["max_abs_err"], err)
    return summary


def serve(gpu: str) -> int:
    runner = Runner("yolo-somi", nc=10, dtype=torch.bfloat16, imgsz=IMGSZ, device="cuda", seed=0)
    cfg = runner.meta.yaml
    assert (cfg["width_multiple"], cfg["depth_multiple"]) == (1.0, 1.0), cfg
    n_params = sum(p.numel() for p in runner.model.parameters())
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8) for _ in range(N_REQUESTS + 1)]
    runner(batches[0])  # warm-up: cuDNN plans, allocator
    torch.cuda.synchronize()

    odconv_s2.launches = 0
    lat = []
    for images in batches[1:]:
        t0 = time.perf_counter()
        out = runner(images)  # ends in a device->host copy of the detections
        lat.append(time.perf_counter() - t0)
        assert out.shape == (BATCH, 300, 6) and np.isfinite(out).all(), out.shape
        valid = out[..., 4] > 0
        assert (out[~valid] == 0).all()
    launches = odconv_s2.launches
    n_sites = len(odconv_sites(runner.meta, BATCH, IMGSZ))
    assert n_sites == 4 and launches == n_sites * N_REQUESTS, (n_sites, launches)
    med = statistics.median(lat)
    print(f"serving yolo-somi full width ({n_params / 1e6:.2f} M params) 640 px bf16 b{BATCH}, "
          f"{N_REQUESTS} requests on {gpu}: latency median {med * 1e3:.2f} ms/batch "
          f"(min {min(lat) * 1e3:.2f}, max {max(lat) * 1e3:.2f}), {BATCH / med:.1f} img/s, "
          f"detections/img {valid.sum(1).mean():.1f}, odconv_s2 launches {launches} ({launches // N_REQUESTS}/batch)")

    # the batch split by layer: upload + model, then postprocess (NMS)
    fwd, post = [], []
    for images in batches[1:]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds = runner.forward(images)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fused_postprocess(preds, runner.meta.anchors_px, runner.meta.strides).cpu()
        fwd.append(t1 - t0)
        post.append(time.perf_counter() - t1)
    print(f"split: upload+model median {statistics.median(fwd) * 1e3:.2f} ms/batch, "
          f"postprocess median {statistics.median(post) * 1e3:.2f} ms/batch")

    # where the device time goes, one batch under the profiler
    OUT.mkdir(exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        runner(batches[1])
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    ours_ms = sum(e.self_device_time_total for e in kernels if "odconv_s2" in e.key) / 1e3
    table = events.table(sort_by="self_device_time_total", row_limit=40)
    (OUT / "chip_smoke_profile.txt").write_text(f"{gpu}\n{table}\n")
    print(f"profile (one batch, profiler on): wall {wall_ms:.2f} ms, device kernels {busy_ms:.3f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% busy), odconv_s2 kernels {ours_ms:.3f} ms "
          f"({100 * ours_ms / max(busy_ms, 1e-9):.1f}% of device time); table in {OUT / 'chip_smoke_profile.txt'}")
    return launches


def parity() -> None:
    """The full-width model in f32 through the kernel and through its plain
    version, on one batch of 2, each held against the plain version in f64.

    A fixed atol cannot hold here: head outputs reach ~170 and 36 random
    layers amplify f32 rounding, so the plain f32 model itself misses f64
    by ~1e-2. The kernel
    passes when its f32 model is no further from f64 than twice the plain
    f32 model is."""
    runner = Runner("yolo-somi", nc=10, dtype=torch.float32, imgsz=IMGSZ, device="cuda", seed=0)
    images = np.random.default_rng(1).integers(0, 256, (2, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    before = odconv_s2.launches
    raw = runner.forward(images)
    assert odconv_s2.launches == before + 4
    with plain_version():
        ref = runner.forward(images)
        with torch.inference_mode():
            x64 = torch.from_numpy(images).cuda().permute(0, 3, 1, 2).double() / 255.0
            ref64 = copy.deepcopy(runner.model).double()(x64)
    assert odconv_s2.launches == before + 4
    for i, (a, b, c) in enumerate(zip(raw, ref, ref64)):
        assert a.shape == b.shape == c.shape and torch.isfinite(a).all()
        k_err = (a.double() - c).abs().max().item()
        p_err = (b.double() - c).abs().max().item()
        diff = (a - b).abs().max().item()
        print(f"parity level {i}: max |out| {c.abs().max().item():.3e}, kernel-vs-plain {diff:.3e}, "
              f"vs f64: kernel {k_err:.3e} plain {p_err:.3e}")
        assert k_err <= 2 * p_err + 1e-6, (i, k_err, p_err)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    gpu = gpu_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {gpu} | torch {torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off for matmul and cuDNN: f32 comparisons run in full f32")

    t0 = time.perf_counter()
    lib = build.build("odconv_s2.cu")
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in build.BUILD_LOG.get("odconv_s2.cu", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    _, meta = parse_model(load_model_cfg(find_config("yolo-somi")))
    sites = odconv_sites(meta, BATCH, IMGSZ)
    summary = check_kernel(sites, torch.Generator(device="cuda").manual_seed(0))

    launches = serve(gpu)
    parity()

    kernel = {
        "name": "odconv_s2",
        "route": "cuda",
        "source": "yolosomi_tpu_torch/ops/csrc/odconv_s2.cu",
        "replaces": "yolosomi_tpu/ops/odconv_pallas.py:111",
        "launches": launches,
        "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"],
        "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"],
        "bound_by": "bytes" if summary["t_bytes"] >= summary["t_ops"] else "operations",
        "library_ms": summary["library_ms"],
    }
    print(gpu)
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
