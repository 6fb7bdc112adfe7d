"""How far rounding alone moves a full-width f32 train step's gradients, on one GPU.

    python3 probe_step_noise.py [graph ...]

For the named graphs of yolosomi_tpu_torch/models/zoo_graphs.py or configs
(by default zoo-fusion and the flagship, yolo-somi), each at 640 px, b2, seed-0 weights with the head tempered, on phase 8's
synthetic set (chip_smoke.py's train_step_parity setup): the step through
the kernels, the plain step (plain_version()), and the plain step from
parameters nudged by one ulp (x (1 + 2**-23)), each against the plain
step in float64. Prints each step's median relative gradient distance
from float64, the nudged step's from the plain one, and the parameters
each of the kernels' and the nudged step puts over phase 8(b)'s one-draw
rule (4 x the larger of the plain step's distance and its median, plus
1e-6 of the largest gradient). chip_smoke.py's STEP_SECOND_DRAW takes the
nudged step as a second noise draw where this shows the one-draw rule
failing a plain step. About a minute on an H100.
"""

import copy
import statistics
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from yolosomi_tpu_torch.models.zoo_graphs import ZOO_GRAPHS, zoo_graph
from yolosomi_tpu_torch.ops.odconv import plain_version


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).norm().item() / max(b.double().norm().item(), 1e-300)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_step_noise: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.SOURCES = ("odconv_s2.cu", "odconv_s2_bwd.cu")
    cs.build_all()
    print(cs.gpu_line())
    hyp = cs.load_hyp(cs.find_config("hyp.visdrone", "hyps"))
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp) / "shapes"
        cs.write_shapes_split(root, "train", cs.TRAIN_IMAGES, np.random.default_rng(0))
        ds = cs.DetectionDataset(str(root / "train" / "images"), img_size=cs.IMGSZ)
        images, targets, _, _ = next(iter(cs.DataLoader(ds, 2)))
        for name in sys.argv[1:] or ("zoo-fusion", "yolo-somi"):
            cfg = zoo_graph(name) if name in ZOO_GRAPHS else cs.load_model_cfg(cs.find_config(name))
            model, meta = cs.build_model(cfg, nc=10, device="cuda", seed=0)
            cs.temper_head(model, cs.HEAD_TEMPER)
            plain, nudged, f64 = copy.deepcopy(model), copy.deepcopy(model), copy.deepcopy(model).double()
            with torch.no_grad():
                for q in nudged.parameters():
                    q.mul_(1 + 2 ** -23)
            loss_fn = cs.ComputeLoss(meta, hyp)
            steps = {"kernels": cs.step_grads(model, loss_fn, images, targets)}
            with plain_version():
                steps["plain"] = cs.step_grads(plain, loss_fn, images, targets)
                steps["nudged plain"] = cs.step_grads(nudged, loss_fn, images, targets)
                loss_d, grads_d = cs.step_grads(f64, loss_fn, images, targets)
            names = [n for n, _ in model.named_parameters()]
            medians = {k: statistics.median(rel(g, d) for g, d in zip(grads, grads_d)) for k, (_, grads) in steps.items()}
            top = max(d.norm().item() for d in grads_d)
            grads_p = steps["plain"][1]
            print(f"{name} f32 b2 {cs.IMGSZ} px: losses " + ", ".join(f"{k} {v[0].item():.7f}" for k, v in steps.items())
                  + f", f64 {loss_d.item():.7f}; median relative gradient distance to f64: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in medians.items())
                  + f"; nudged plain to plain {statistics.median(rel(a, b) for a, b in zip(steps['nudged plain'][1], grads_p)):.3e}")
            for k in ("kernels", "nudged plain"):
                over = []
                for n, g, p, d in zip(names, steps[k][1], grads_p, grads_d):
                    e, ep, nd = (g.double() - d).norm().item(), (p.double() - d).norm().item(), d.norm().item()
                    if e > 4 * max(ep, medians["plain"] * nd) + 1e-6 * top:
                        over.append(f"{n} ({e:.3e} against the plain step's {ep:.3e}, norm {nd:.3e})")
                print(f"{name} {k}: {len(over)} of {len(names)} parameters over the one-draw rule"
                      + (": " + "; ".join(over) if over else ""))
            del model, plain, nudged, f64, steps, grads_d
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
