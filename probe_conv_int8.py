"""conv_int8 at every distinct ConvRaw shape of one served b8 batch of the
full-width flagship (640 px, bf16, seed 0, per-tensor scales calibrated on
the batch), on one NVIDIA GPU:

    python3 probe_conv_int8.py [--parent DIR] [--plans]

On the batch's own operands (captured as chip_smoke.py's phase 12 captures
them) it times, cold L2 (chip_smoke.time_ms), the fused kernel
(conv_int8_fused: the quantize inside the kernel's loads) and the
int8-input kernel (conv_int8 on the quantized x), each checked bitwise
against its plain version. With --parent, DIR is another checkout's root
(conv_int8 before its redesign): its csrc/conv_int8.cu is built and timed
in the same process on the same operands, alone on the quantized x and
behind the PyTorch quantize passes that served int8 then ran before it
(x.float(), / s_a, round, clamp, .to(int8), the NHWC copy), and its
output is held to the fused kernel's bits. With --plans, the fused kernel
at each implicit-GEMM shape is also timed under the other tile widths BN
that fit N, the chosen one marked `*`. Each shape prints a line; the
sums per batch follow, by shape class (chip_smoke.int8_class) and in all.
A diagnostic: chip_smoke.py holds the kernel in the serving path.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import BATCH, IMGSZ, conv_int8_calls, gpu_line, int8_class, time_ms, TIME_REPS
from yolosomi_tpu_torch.engine.runner import Runner
from yolosomi_tpu_torch.ops import build
from yolosomi_tpu_torch.ops.int8 import (_BN_WIDTHS, _OUT_KIND, _PTR, _INT, _conv_int8_plan, _out_hw, conv_int8,
                                         conv_int8_fused, conv_int8_fused_reference, gemm_plan, quantize_activation)

REPS = 10


def parent_entry(root: Path):
    """The parent's conv_int8 (int8 x, unpacked OHWI weights), built from
    root's conv_int8.cu."""
    src = root / "yolosomi_tpu_torch" / "ops" / "csrc" / "conv_int8.cu"
    out = build.BUILD_DIR / "parent_conv_int8.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(out), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).conv_int8
    fn.argtypes, fn.restype = [_PTR] * 5 + [_INT] * 18 + [_PTR], ctypes.c_int
    return fn


def parent_call(fn, x_q, w_q, scale, bias, stride, padding, dilation, groups, out_dtype):
    """The parent's conv_int8, as its wrapper called it."""
    B, H, W, C = x_q.shape
    N, kh, kw, _ = w_q.shape
    Ho, Wo = _out_hw(H, W, (kh, kw), stride, padding, dilation)
    out = torch.empty((B, Ho, Wo, N), device=x_q.device, dtype=out_dtype)
    vec = int(groups == 1 and C % 16 == 0 and x_q.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0)
    rc = fn(x_q.data_ptr(), w_q.data_ptr(), scale.data_ptr(), bias.data_ptr() if bias is not None else None,
            out.data_ptr(), B, H, W, C, Ho, Wo, N, kh, kw, *stride, *padding, *dilation, groups, _OUT_KIND[out_dtype],
            vec, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent conv_int8: CUDA error {rc}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_conv_int8: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="root of a checkout whose conv_int8.cu to time beside this one's")
    ap.add_argument("--plans", action="store_true", help="time the fused kernel under other GEMM tiles too")
    opt = ap.parse_args()
    gpu = gpu_line()
    print(f"device: {gpu} | torch {torch.__version__} cuda {torch.version.cuda}")
    parent = parent_entry(opt.parent) if opt.parent else None
    runner = Runner("yolo-somi", dtype=torch.bfloat16, imgsz=IMGSZ, device="cuda", seed=0)
    images = np.random.default_rng(0).integers(0, 256, (BATCH, IMGSZ, IMGSZ, 3), dtype=np.uint8)
    calls = conv_int8_calls(runner, images)
    TIME_REPS[0] = REPS
    sums, classes = {}, {}
    for key, (count, (x, s_a, w_q, packed, scale, bias)) in sorted(calls.items(), key=lambda kv: -kv[0][0][1]):
        xs, ws, stride, padding, dilation, groups, _, out_dtype = key
        kw = dict(stride=stride, padding=padding, dilation=dilation, groups=groups)
        x_q = quantize_activation(x, s_a).contiguous()
        ref = conv_int8_fused_reference(x, s_a, w_q, scale, bias, out_dtype=out_dtype, **kw)
        got = conv_int8_fused(x, s_a, w_q, scale, bias, out_dtype=out_dtype, packed=packed, **kw)
        assert torch.equal(got, ref), key
        assert torch.equal(conv_int8(x_q, w_q, scale, bias, out_dtype=out_dtype, packed=packed, **kw), ref), key
        times = {
            "fused": time_ms(lambda: conv_int8_fused(x, s_a, w_q, scale, bias, out_dtype=out_dtype, packed=packed,
                                                     **kw)),
            "int8_input": time_ms(lambda: conv_int8(x_q, w_q, scale, bias, out_dtype=out_dtype, packed=packed,
                                                    **kw)),
        }
        if parent is not None:
            x_nchw = x.permute(0, 3, 1, 2)

            def with_passes():
                xq = torch.clamp(torch.round(x_nchw.float() / s_a), -127, 127).to(torch.int8)
                return parent_call(parent, xq.permute(0, 2, 3, 1).contiguous(), w_q, scale, bias, out_dtype=out_dtype,
                                   **kw)

            assert torch.equal(parent_call(parent, x_q, w_q, scale, bias, out_dtype=out_dtype, **kw), ref), key
            assert torch.equal(with_passes(), ref), key
            times["parent_kernel"] = time_ms(lambda: parent_call(parent, x_q, w_q, scale, bias, out_dtype=out_dtype,
                                                                 **kw))
            times["parent_with_passes"] = time_ms(with_passes)
        plan = _conv_int8_plan(xs, ws, stride, padding, dilation, groups)
        tiles = f"64x{plan.bn}" if plan.route == "gemm" else f"{plan.th}x{plan.tw}x{plan.cb}"
        alts = ""
        if opt.plans and plan.route == "gemm":
            N = ws[0]
            widths = sorted({next((w for w in _BN_WIDTHS if w >= N), 256), *(w for w in (64, 128, 256) if w < N * 2)})
            alt = {}
            for bn in widths:
                p = gemm_plan(xs, ws, stride, padding, dilation, bn)
                fn = lambda: conv_int8_fused(x, s_a, w_q, scale, bias, out_dtype=out_dtype, packed=packed,  # noqa: E731
                                             plan=p, **kw)
                assert torch.equal(fn(), ref), (key, bn)
                alt[bn] = time_ms(fn)
            best = min(alt, key=alt.get)
            alts = "; tiles " + " ".join(f"64x{bn}{'*' if bn == plan.bn else ''} {ms:.4f}" for bn, ms in alt.items()) \
                + f"; best 64x{best}"
            times["best_tiles"] = alt[best]
        cls = classes.setdefault(int8_class(xs, ws, groups), {"launches": 0})
        cls["launches"] += count
        for name, ms in times.items():
            sums[name] = sums.get(name, 0.0) + count * ms
            cls[name] = cls.get(name, 0.0) + count * ms
        print(f"conv_int8 x{xs} w{ws} s{stride} p{padding} d{dilation} g{groups} x{count}/batch ({plan.route} "
              f"{tiles}): " + " ".join(f"{name}_ms {ms:.4f}" for name, ms in times.items()) + alts)
    for name, cls in classes.items():
        print(f"class {name} x{cls['launches']}/batch: " +
              " ".join(f"{k}_ms {v:.3f}" for k, v in cls.items() if k != "launches"))
    print(f"per batch ({len(calls)} shapes, {sum(c for c, _ in calls.values())} launches) on {gpu}: " +
          " ".join(f"{name}_ms {ms:.3f}" for name, ms in sums.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
