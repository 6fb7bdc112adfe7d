"""The bf16 gradient kernels of ODConv under every launch plan, at the four
ODConv sites of the flagship (b8, 640 px), on one NVIDIA GPU:

    python3 probe_odconv_bwd.py

On inputs drawn as chip_smoke.py draws them, it times (cold L2,
chip_smoke.time_ms) odconv_s2_dx under each of its tile configurations and
odconv_s2_dwmix under each of its tile configurations and several splits
of the pixel reduction, marks the plan ops/odconv.py chooses (`_dx_plan`,
`_dw_plan`) with a `*`, and prints `_dw_cost`'s estimate beside each dwmix
time. Every plan's result is held to autograd of the plain version in f32
within chip_smoke.GRAD_TOL. A diagnostic for the plan functions:
chip_smoke.py holds the planned kernels against their plain versions.
"""

from __future__ import annotations

import sys

import torch

from chip_smoke import BATCH, GRAD_TOL, IMGSZ, gpu_line, odconv_sites, time_ms
from yolosomi_tpu_torch.models.yolo import parse_model
from yolosomi_tpu_torch.ops.odconv import (_DW_TILES, _DX_TILES, _dw_cost, _dw_kernel, _dw_plan,
                                           _dx_kernel, _dx_plan, _k_splits,
                                           odconv_s2_backward_reference)
from yolosomi_tpu_torch.utils.config import find_config, load_model_cfg

SPLITS = (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16)


def rel(a: torch.Tensor, ref: torch.Tensor) -> float:
    return ((a.float() - ref).norm() / ref.norm()).item()


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_odconv_bwd: no CUDA device", file=sys.stderr)
        return 1
    print(gpu_line())
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, meta = parse_model(load_model_cfg(find_config("yolo-somi")))
    for row, xs, ws in odconv_sites(meta, BATCH, IMGSZ):
        B, H, W, C = xs
        cout = ws[-1]
        x = torch.randn(xs, device="cuda", generator=gen).bfloat16()
        w = (torch.randn(ws, device="cuda", generator=gen) * (2.0 / (9 * C)) ** 0.5).bfloat16()
        dy = torch.randn((B, H // 2, W // 2, cout), device="cuda", generator=gen).bfloat16()
        P = (H // 2) * (W // 2)
        ref_dx, ref_dw = odconv_s2_backward_reference(x.float(), w.float(), dy.float())
        cells = []
        for cfg in sorted(_DX_TILES):
            err = rel(_dx_kernel(dy, w, H, W, cfg), ref_dx)
            assert err <= GRAD_TOL[torch.bfloat16], (row, "dx", cfg, err)
            t = time_ms(lambda: _dx_kernel(dy, w, H, W, cfg))
            cells.append(f"{'*' if cfg == _dx_plan(C) else ''}tiles {cfg} (BN {_DX_TILES[cfg][0]}) {t:.4f}")
        print(f"odconv_s2_dx row {row} x{tuple(xs)} cout {cout} bf16 ms: " + "; ".join(cells))
        plan = _dw_plan(B, H, W, C, cout)
        for cfg in sorted(_DW_TILES):
            cells = []
            for split in SPLITS:
                if _k_splits(P, split)[-1][0] >= P:
                    continue  # an empty last part
                err = rel(_dw_kernel(x, dy, cfg, split), ref_dw)
                assert err <= GRAD_TOL[torch.bfloat16], (row, "dwmix", cfg, split, err)
                t = time_ms(lambda: _dw_kernel(x, dy, cfg, split))
                mark = "*" if (cfg, split) == plan else ""
                cells.append(f"{mark}split {split} {t:.4f} (model {_dw_cost(B, H, W, C, cout, cfg, split) * 1e3:.4f})")
            print(f"odconv_s2_dwmix row {row} x{tuple(xs)} cout {cout} bf16 tiles {cfg} (BN {_DW_TILES[cfg][0]}) ms: "
                  + "; ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
