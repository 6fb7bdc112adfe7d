"""Data parallelism over torch.distributed (counterpart of
yolosomi_tpu/parallel/mesh.py:1-64).

The JAX package shards each global batch over a ('data', 'model') mesh and
jit derives the collectives, so its sharded step *is* the one-device step
on the global batch: BatchNorm statistics and the loss's normalisers are
global by construction. Here every rank is a process holding one slice of
the global batch, and the collectives are explicit, so that a step on W
ranks equals the one-process step on all B images up to the order of f32
sums:
- `shard_batch` gives rank r the rows [r B / W, (r + 1) B / W), the slice
  that P('data') puts on device r;
- `replicate_` broadcasts a module's parameters and buffers from rank 0
  (replicate_tree);
- `all_reduce_sum` is a sum all-reduce with a sum all-reduce as its
  backward: the global BatchNorm (models/layers.py) sums its per-channel
  moments with it, so the gradient of every rank's partial loss reaches
  every rank's activations;
- `all_reduce_flat` sums a list of tensors as one flat buffer per dtype
  (the train step's gradients, the loss's normalisers, the metrics).
Only all_reduce and broadcast are used: gloo takes CUDA tensors for those
two, so two gloo ranks can share one card.

`reducing(group)` marks the code that runs the collectives: the train step
enters it around its forward, loss and backward; outside it (validation,
serving, the pipeline) every module computes as in one process, bit for
bit. A group is made by `init_data_parallel` (torchrun's environment;
NCCL on CUDA, gloo on the CPU) or by `spawn_local`, which runs W ranks as
processes on one machine with a file rendezvous (the tests' stand-in for
JAX's virtual CPU devices). Spatial sharding of the mesh's 'model' axis
for serving is parallel/spatial.py; channel sharding is not ported
(ROADMAP queue A item 6).
"""

from __future__ import annotations

import contextlib
import os
import pickle
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

# a collective that waits longer than this fails its rank instead of hanging it: under torchrun long
# enough for rank 0's validation of a real val set, which the other ranks wait out
TIMEOUT_S = 600


@dataclass(frozen=True)
class DataGroup:
    """This process's place in the default process group: its rank, the
    world size, and the device that host-side values travel through
    (cuda:<current> under NCCL, the CPU under gloo)."""

    rank: int
    world: int
    device: torch.device

    @property
    def is_main(self) -> bool:
        return self.rank == 0


# the group the running train step reduces over (None: one process)
ACTIVE: list = [None]


@contextlib.contextmanager
def reducing(group: Optional[DataGroup]):
    """Run the global BatchNorm and the loss's global normalisers over
    `group` inside the block (nothing changes with None)."""
    prev = ACTIVE[0]
    ACTIVE[0] = group
    try:
        yield
    finally:
        ACTIVE[0] = prev


def active() -> Optional[DataGroup]:
    return ACTIVE[0]


def current_group() -> Optional[DataGroup]:
    """The initialised default group, or None."""
    if not dist.is_available() or not dist.is_initialized():
        return None
    dev = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")
    return DataGroup(dist.get_rank(), dist.get_world_size(), dev)


def init_data_parallel() -> Optional[DataGroup]:
    """The default group from torchrun's RANK / WORLD_SIZE / LOCAL_RANK
    (and MASTER_ADDR / MASTER_PORT), or the one already initialised; None
    when neither exists. NCCL when CUDA is present (the rank's card is
    cuda:LOCAL_RANK), else gloo. A failed initialisation raises."""
    group = current_group()
    if group is not None or "WORLD_SIZE" not in os.environ:
        return group
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=timedelta(seconds=TIMEOUT_S))
    return current_group()


def shard_batch(x, rank: int, world: int):
    """Rank `rank`'s contiguous slice of the leading axis of `x` (an array,
    a tensor, or a dict / list / tuple of them), as JAX's shard_batch puts
    rows [r B / W, (r + 1) B / W) on device r."""
    if isinstance(x, dict):
        return {k: shard_batch(v, rank, world) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(shard_batch(v, rank, world) for v in x)
    n = x.shape[0]
    if n % world:
        raise ValueError(f"a batch of {n} does not split over {world} ranks")
    b = n // world
    return x[rank * b:(rank + 1) * b]


def all_reduce_flat(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """The element-wise sums of `tensors` over the group, as views of one
    flat buffer per (dtype, device); the inputs are not changed."""
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    keys = {}
    for i, t in enumerate(tensors):
        keys.setdefault((t.dtype, t.device), []).append(i)
    for idx in keys.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            out[i] = part.view(tensors[i].shape)
    return out


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x; dx = sum over ranks of dy (every rank's
    partial loss depends on every rank's x through y)."""

    @staticmethod
    def forward(ctx, x):
        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, dy):
        dx = dy.contiguous().clone()
        dist.all_reduce(dx)
        return dx


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The differentiable sum all-reduce."""
    return _AllReduceSum.apply(x)


@torch.no_grad()
def replicate_(module: torch.nn.Module) -> torch.nn.Module:
    """Every parameter and buffer of `module` broadcast from rank 0, in
    place (replicate_tree)."""
    tensors = [t for t in list(module.parameters()) + list(module.buffers())]
    keys = {}
    for t in tensors:
        keys.setdefault((t.dtype, t.device), []).append(t)
    for ts in keys.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.broadcast(flat, 0)
        torch._foreach_copy_(ts, [p.view(t.shape) for p, t in zip(flat.split([t.numel() for t in ts]), ts)])
    return module


def broadcast_object(obj, group: DataGroup):
    """Rank 0's `obj` (anything picklable) on every rank."""
    payload = pickle.dumps(obj) if group.is_main else b""
    n = torch.tensor([len(payload)], dtype=torch.int64, device=group.device)
    dist.broadcast(n, 0)
    buf = (torch.from_numpy(np.frombuffer(payload, np.uint8).copy()).to(group.device) if group.is_main
           else torch.empty(int(n.item()), dtype=torch.uint8, device=group.device))
    dist.broadcast(buf, 0)
    return obj if group.is_main else pickle.loads(buf.cpu().numpy().tobytes())


def barrier(group: DataGroup) -> None:
    """Every rank waits here for the others (an all-reduce of one value)."""
    dist.all_reduce(torch.zeros(1, device=group.device))


# ---------------------------------------------------------------------------
# local ranks as processes
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world: int, tmp: str, backend: str, timeout: float, threads: int, fn: Callable,
               args: tuple) -> None:
    torch.set_num_threads(threads)
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")  # every rank is on this machine
    try:
        dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'rendezvous')}", rank=rank,
                                world_size=world, timeout=timedelta(seconds=timeout))
        try:
            result = fn(current_group(), *args)
        finally:
            dist.destroy_process_group()
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    except Exception:  # the process's boundary: the parent reads the traceback, the exit code is 1
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn_local(world: int, fn: Callable, *args, backend: str = "gloo", timeout: float = 120,
                threads: int = 1) -> list:
    """Run fn(group, *args) on `world` ranks, each a spawned process of this
    machine with `threads` torch threads, joined by a file rendezvous in a
    temporary directory; returns the ranks' results in rank order. `fn`
    must be importable by its module path. A rank that fails, or a run
    longer than `timeout` seconds, stops every rank and raises with the
    failed rank's traceback."""
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="somi-ranks-") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(r, world, tmp, backend, timeout, threads, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        failed = [(r, p.exitcode) for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            errs = [p.read_text() for p in sorted(Path(tmp).glob("rank*.err"))]
            late = time.monotonic() > deadline
            raise RuntimeError(f"ranks (rank, exit code) {failed} failed{' after the timeout' if late else ''}:\n"
                               + "\n".join(errs))
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)]
