"""How far rounding alone puts a data-parallel step from one process's, and
how far a fault puts it, for the full-width flagship on one NVIDIA GPU:

    python3 probe_data_parallel.py

For seeds 0-2 (head tempered, as chip_smoke.py builds it), in bf16 autocast
and in f32, one train-mode forward and ComputeLoss of chip_smoke.py's b8
batch in one process, then on 2 gloo ranks sharing cuda:0 (b4 each) with
the global BatchNorm in three forms: the program's (each rank's moments
merged in float64 by one all-reduce), the earlier two-pass form (the mean,
then the variance about it, each its own f32 all-reduce), and, as a fault,
per-rank statistics. It prints the global loss's distance from one
process's and, for the BatchNorms BNS, the relative norm distance of the
running statistics' moves. A diagnostic, not a check: it calibrates
chip_smoke.py's DP_LOSS and DP_BN_TOL.
"""

from __future__ import annotations

import sys

import torch
import torch.distributed as dist
import torch.nn.functional as F

import chip_smoke as cs
from yolosomi_tpu_torch.models import layers
from yolosomi_tpu_torch.parallel import mesh

PROGRAM = layers._FlaxRunningStats._global_forward
BNS = (0, 1, 2, 3, 4, 5, 20, 50, 102)  # indices among the flagship's 103 BatchNorms, in module order
SEEDS = (0, 1, 2)


def two_pass(self, x):
    """The global BatchNorm as two f32 all-reduces."""
    dims = [0] + list(range(2, x.dim()))
    shape = (1, -1, *([1] * (x.dim() - 2)))
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    n = float(x.numel() // x.shape[1] * mesh.active().world)
    mean = mesh.all_reduce_sum(xf.sum(dims)) / n
    d = xf - mean.view(shape)
    var = mesh.all_reduce_sum((d * d).sum(dims)) / n
    with torch.no_grad():
        self.running_mean.mul_(1.0 - self.momentum).add_(mean, alpha=self.momentum)
        self.running_var.mul_(1.0 - self.momentum).add_(var, alpha=self.momentum)
    mul = torch.rsqrt(var + self.eps) * self.weight.to(xf.dtype)
    return (d * mul.view(shape) + self.bias.to(xf.dtype).view(shape)).to(x.dtype)


def per_rank(self, x):
    """The fault: each rank's own statistics."""
    return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, True, self.momentum,
                        self.eps)


FORMS = {"merged moments (the program)": PROGRAM, "two all-reduces": two_pass,
         "per-rank statistics (a fault)": per_rank}


def forward_loss(group, seed: int, amp: bool, form, x, t):
    """The global loss of one train-mode forward of a fresh seed-`seed`
    model, and the moves of the BatchNorms BNS's running statistics."""
    model, meta = cs.build_model(cs.load_model_cfg(cs.find_config("yolo-somi")), nc=10, device="cuda", seed=seed,
                                 compute_dtype=torch.bfloat16 if amp else None)
    cs.temper_head(model, cs.HEAD_TEMPER)
    model.train()
    bns = [m for m in model.modules() if isinstance(m, layers._FlaxRunningStats)]
    before = [torch.cat([bns[i].running_mean, bns[i].running_var]).clone() for i in BNS]
    ctx = torch.autocast("cuda", dtype=torch.bfloat16) if amp else torch.autocast("cuda", enabled=False)
    layers._FlaxRunningStats._global_forward = form
    try:
        with torch.no_grad(), mesh.reducing(group):
            with ctx:
                preds = model(x)
            loss, _ = cs.ComputeLoss(meta, cs.load_hyp(cs.find_config("hyp.visdrone", "hyps")))(preds, t)
    finally:
        layers._FlaxRunningStats._global_forward = PROGRAM
    if group is not None:
        dist.all_reduce(loss)
    moves = [(torch.cat([bns[i].running_mean, bns[i].running_var]) - b).cpu() for i, b in zip(BNS, before)]
    return loss.item(), moves


def run(group, images, targets) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = (group.rank, group.world) if group is not None else (0, 1)
    x = cs.upload_images(mesh.shard_batch(images, rank, world), torch.device("cuda"))
    t = torch.as_tensor(mesh.shard_batch(targets, rank, world), device="cuda")
    forms = FORMS if group is not None else {"one process": PROGRAM}
    out = {}
    for seed in SEEDS:
        for amp in (True, False):
            for name, form in forms.items():
                out[(seed, amp, name)] = forward_loss(group, seed, amp, form, x, t)
                torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_data_parallel: no CUDA device", file=sys.stderr)
        return 1
    print(cs.gpu_line())
    cs.build_all()
    images, targets = cs.dp_batch()
    ref = run(None, images, targets)
    ranks = mesh.spawn_local(2, run, images, targets, backend="gloo", timeout=600, threads=4)
    for (seed, amp, name), (loss, moves) in ranks[0].items():
        ref_loss, ref_moves = ref[(seed, amp, "one process")]
        dist_bn = ", ".join(f"{i}: {((a - b).norm() / b.norm()).item():.2e}" for i, a, b in zip(BNS, moves, ref_moves))
        print(f"seed {seed} {'bf16' if amp else 'f32 '} {name:30s} loss on 2 ranks {loss:.7f}, one process "
              f"{ref_loss:.7f}, relative {loss / ref_loss - 1:+.3e}; BatchNorm statistics' moves, relative norm "
              f"distance by BatchNorm {dist_bn}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
