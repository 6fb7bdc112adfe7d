"""Where dcnv3_core's time goes at the DCNv3 site of yolo-somi-dcn (row 10,
b8, 640 px), on one NVIDIA GPU:

    python3 probe_dcnv3.py

On chip_smoke.py's inputs for the site, in f32 and bf16, it times (cold L2,
chip_smoke.time_ms) the kernel as served, then the same launch with every
sampling point moved to pixel (0.5, 0.5), whose four corners stay in L1,
and to (-10, -10), off the map, where the kernel loads no corner but runs
the same decode, shuffles and FMAs. A diagnostic, not a check:
chip_smoke.py holds the kernel against its plain version.
"""

from __future__ import annotations

import sys

import torch

from chip_smoke import BATCH, IMGSZ, dcn_sites, dcnv3_site, gpu_line, time_ms
from yolosomi_tpu_torch.ops.dcn import dcnv3_core


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_dcnv3: no CUDA device", file=sys.stderr)
        return 1
    print(gpu_line())
    gen = torch.Generator(device="cuda").manual_seed(0)
    for site in dcn_sites("yolo-somi-dcn", BATCH, IMGSZ)[1]:
        d = dcnv3_site(site, gen)
        N, H, W, G, Cg, Ho, Wo, P = d["shape"]

        def offsets_to(xy: float) -> torch.Tensor:
            """Offsets that move every point to the pixel coordinate (xy, xy)."""
            o = torch.stack(torch.broadcast_tensors(xy - d["bx"], xy - d["by"], d["px"]), -1)[..., :2]
            return o.reshape(N, Ho, Wo, G * P * 2)

        for dtype in (torch.float32, torch.bfloat16):
            v, m = d["v32"].to(dtype), d["m32"].to(dtype)
            times = {name: time_ms(lambda o=o.to(dtype).contiguous(): dcnv3_core(v, o, m, *d["args"]))
                     for name, o in (("served", d["o32"]), ("l1", offsets_to(0.5)), ("none", offsets_to(-10.0)))}
            t = times["served"]
            print(f"dcnv3_core row {site[0]} x{site[2]} G {G} P {P} {str(dtype)[6:]}: kernel_ms {t:.4f}; "
                  f"every corner an L1 hit {times['l1']:.4f} ({100 * times['l1'] / t:.0f}%), "
                  f"no corner on the map {times['none']:.4f} ({100 * times['none'] / t:.0f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
