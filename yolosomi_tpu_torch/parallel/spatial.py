"""Spatial sharding for serving (counterpart of the JAX Runner's
`spatial_shards`, yolosomi_tpu/engine/runner.py:36-47 and :227-238, and of
yolosomi_tpu/parallel/mesh.py:100-110).

The JAX package puts an image batch on a ('data', 'model') mesh with H
split over 'model', and XLA's partitioner derives every halo exchange.
Torch has none, so here each rank holds one H-strip of every activation
and the few operators that look across rows ask for what they need while
`spatial(strip)` is active:
- `halo_rows` fetches real rows from the strips above and below (a conv's
  or a pool's window), and `fill` past the image's edges;
- `strip_sum_hw` / `strip_mean_hw` / `strip_amax_hw` reduce over the whole
  map (attention gates, ODConv's trunk, GroupNorm);
- `gather_h` rebuilds the whole map along H (the deformable blocks sample
  anywhere in it; EMA-CBAM's h-profile);
- `gather_level_outputs` rebuilds the head's whole maps of the whole batch
  on every rank, as the JAX Runner's replicated `out_shardings` does.
Outside the context every operator computes as in one process, bit for
bit.

The mesh: a world of W = D x S ranks; rank r holds batch slice r // S
(`mesh.shard_batch`) and strip r % S, as JAX's
`devices.reshape(data, model)` places them (mesh.py:38). Strip bounds are
multiples of the model's largest stride, so at every level a strip starts
on a whole, even row; the rows split as evenly as that allows (256 px over
3 strips at stride 32: 96 / 96 / 64 px).

Every exchange is one `all_reduce`: a gather writes this rank's rows into
a zeroed buffer that all ranks sum, as bytes (uint8), so each element is
one rank's bits plus zeros and comes back exact in any dtype; a whole-map
sum or max is a sum or max all-reduce. Gloo takes CUDA tensors for
all_reduce and broadcast alone, so two gloo ranks can share one card. The
cost is a buffer a strip per exchange, which is small beside the
activations (`Strip.stats` counts the bytes). No backward: JAX shards
only serving.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from yolosomi_tpu_torch.parallel import mesh

TORCHRUN = ("torchrun --standalone --nproc-per-node <W> -m yolosomi_tpu_torch.val --shard-spatial <S> ... "
            "(W a multiple of S; detect the same way)")


@dataclass(frozen=True)
class StripPlan:
    """The image rows [bounds[i], bounds[i + 1]) of strip i."""

    height: int
    unit: int
    bounds: Tuple[int, ...]

    @property
    def shards(self) -> int:
        return len(self.bounds) - 1


def strip_plan(height: int, shards: int, unit: int, halo: int = 0) -> StripPlan:
    """`height` rows in `shards` strips whose bounds are multiples of `unit`
    (the model's largest stride), split as evenly as that allows, the first
    strips the longer. Raises where H is not a multiple of the unit, or
    where a strip has fewer rows at the coarsest level than `halo`, the
    largest halo any operator of the model asks of a neighbour."""
    if shards < 1 or unit < 1:
        raise ValueError(f"{shards} strips of {unit}-row units")
    if height % unit:
        raise ValueError(f"an image of {height} rows does not split at multiples of the model's stride {unit}")
    base, extra = divmod(height // unit, shards)
    rows = [base + (i < extra) for i in range(shards)]
    if min(rows) < max(halo, 1):
        raise ValueError(f"{height} rows over {shards} strips leave a strip {min(rows)} rows high at the coarsest "
                         f"level (stride {unit}), fewer than the largest halo of the model, {max(halo, 1)}: use fewer "
                         "strips or a larger image")
    bounds = [0]
    for r in rows:
        bounds.append(bounds[-1] + r * unit)
    return StripPlan(height, unit, tuple(bounds))


@dataclass(frozen=True)
class Level:
    """A strip at one level of the network: this strip's rows [start, stop)
    of the whole map's `height`, and every strip's `bounds`."""

    start: int
    stop: int
    height: int
    bounds: Tuple[int, ...]


@dataclass
class Strip:
    """This rank's place in the spatial mesh for one batch: strip `index` of
    `plan`, batch slice `batch_slice` of `slices`; `group` is the process group
    of the slice's S ranks (None: the default group, where D = 1). `stats`
    counts what this rank all-reduces: bytes and calls, by kind."""

    plan: StripPlan
    index: int
    batch_slice: int
    slices: int
    group: Optional[object] = None
    stats: dict = field(default_factory=lambda: {"halo_bytes": 0, "gather_bytes": 0, "reduce_bytes": 0,
                                                 "output_bytes": 0, "calls": 0})

    @property
    def rows(self) -> slice:
        """This strip's image rows."""
        return slice(self.plan.bounds[self.index], self.plan.bounds[self.index + 1])

    def level(self, rows: int) -> Level:
        """This strip at the level whose local maps have `rows` rows."""
        px = self.plan.bounds[self.index + 1] - self.plan.bounds[self.index]
        f = px // rows if rows else 0
        if rows < 1 or px % rows or self.plan.unit % f:
            raise ValueError(f"a map of {rows} rows is no level of a strip of {px} image rows")
        return Level(self.plan.bounds[self.index] // f, self.plan.bounds[self.index + 1] // f, self.plan.height // f,
                     tuple(b // f for b in self.plan.bounds))

    def all_reduce(self, t: torch.Tensor, kind: str, op=dist.ReduceOp.SUM, world: bool = False) -> None:
        """`t` (contiguous) reduced in place over the slice's ranks, or the
        whole world."""
        dist.all_reduce(t, op=op, group=None if world else self.group)
        self.stats[kind] += t.numel() * t.element_size()
        self.stats["calls"] += 1


class SpatialMesh:
    """The spatial mesh over the default process group (torchrun's or
    spawn_local's): W = D x S ranks, rank r on batch slice r // S and strip
    r % S. Raises where no group is up (never runs unsharded quietly) or W
    is not a multiple of S. With D > 1 it makes one process group per
    slice, which every rank must construct together."""

    def __init__(self, shards: int):
        group = mesh.init_data_parallel()
        if group is None:
            raise RuntimeError(f"spatial_shards={shards} needs a process group of W = D x {shards} ranks, one a "
                               f"strip; none is up. Run under torchrun: {TORCHRUN}")
        if group.world % shards:
            raise ValueError(f"{shards} strips do not divide a world of {group.world} ranks")
        self.shards, self.slices = shards, group.world // shards
        self.batch_slice, self.index = divmod(group.rank, shards)
        self.rank, self.world = group.rank, group.world
        self.group = None
        if self.slices > 1:
            for d in range(self.slices):
                pg = dist.new_group(list(range(d * shards, (d + 1) * shards)))
                if d == self.batch_slice:
                    self.group = pg

    def strip(self, height: int, unit: int, halo: int) -> Strip:
        """This rank's strip of images `height` rows high (strip_plan)."""
        return Strip(strip_plan(height, self.shards, unit, halo), self.index, self.batch_slice, self.slices,
                     self.group)


# the strip the running forward holds (None: the whole map)
ACTIVE: list = [None]


@contextlib.contextmanager
def spatial(strip: Optional[Strip]):
    """Run the model's spatial operators on `strip` inside the block
    (nothing changes with None)."""
    prev = ACTIVE[0]
    ACTIVE[0] = strip
    try:
        yield
    finally:
        ACTIVE[0] = prev


def active_strip() -> Optional[Strip]:
    return ACTIVE[0]


def _empty_in_layout(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """An uninitialised tensor of `shape` laid out in memory as `x` is (its
    dims ordered by x's strides: a channels_last x gives a channels_last
    tensor). Local only: the buffers the ranks exchange are contiguous in
    their own dim order, whatever the strides of one rank's x (a one-row
    strip's can differ from another rank's)."""
    order = sorted(range(x.dim()), key=lambda d: -x.stride(d))
    return x.new_empty([shape[d] for d in order]).permute([order.index(d) for d in range(x.dim())])


def _as_bytes(buf: torch.Tensor) -> torch.Tensor:
    return buf.view(-1).view(torch.uint8)


def halo_rows(x: torch.Tensor, above: int, below: int, fill: float = 0.0, dim: int = 2) -> torch.Tensor:
    """The active strip's local map `x` with `above` rows of the whole map
    before its own along `dim` and `below` after them: real rows of the
    other strips, `fill` past the image's top and bottom edges (0 as a
    conv pads, -inf as a max-pool does). One all-reduce of a buffer that
    holds every strip's halo."""
    _check_unpadded(x)
    st = active_strip()
    lv = st.level(x.shape[dim])
    n = above + below
    if n == 0:
        return x
    shape = list(x.shape)
    shape[dim] = n
    slots = x.new_zeros([st.plan.shards] + shape)
    for j in range(st.plan.shards):
        if j == st.index:
            continue
        for at, lo, hi in ((0, lv.bounds[j] - above, lv.bounds[j]), (above, lv.bounds[j + 1], lv.bounds[j + 1] + below)):
            a, b = max(lo, lv.start), min(hi, lv.stop)
            if a < b:
                slots[j].narrow(dim, at + a - lo, b - a).copy_(x.narrow(dim, a - lv.start, b - a))
    st.all_reduce(_as_bytes(slots), "halo_bytes")
    mine = slots[st.index]
    top, bottom = max(0, above - lv.start), max(0, lv.stop + below - lv.height)
    if top:
        mine.narrow(dim, 0, top).fill_(fill)
    if bottom:
        mine.narrow(dim, n - bottom, bottom).fill_(fill)
    shape[dim] = x.shape[dim] + n
    out = _empty_in_layout(x, shape)
    out.narrow(dim, 0, above).copy_(mine.narrow(dim, 0, above))
    out.narrow(dim, above, x.shape[dim]).copy_(x)
    out.narrow(dim, above + x.shape[dim], below).copy_(mine.narrow(dim, above, below))
    return out


def gather_h(x: torch.Tensor, dim: int = 2) -> torch.Tensor:
    """The whole map of the active strip's local `x` along `dim`, on every
    rank of the slice, contiguous."""
    _check_unpadded(x)
    st = active_strip()
    lv = st.level(x.shape[dim])
    shape = list(x.shape)
    shape[dim] = lv.height
    out = x.new_zeros(shape)
    out.narrow(dim, lv.start, lv.stop - lv.start).copy_(x)
    st.all_reduce(_as_bytes(out), "gather_bytes")
    return out


def _check_unpadded(x: torch.Tensor) -> None:
    """A ZeroPad2d's strip (models/layers.py) holds its pad rows already,
    and only the stride-1 pool after it reads it."""
    if getattr(x, "pad_below", None) is not None:
        raise NotImplementedError("a ZeroPad2d's strip read by another operator than a stride-1 MaxPool2d (ROADMAP "
                                  "queue A item 6)")


def _reduce_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def strip_sum_hw(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """The sum over H and W of the whole map (B, C, H, W) -> (B, C), in f32
    (float64 stays float64): the strips' sums, all-reduced."""
    s = x.to(_reduce_dtype(x)).sum((2, 3), keepdim=keepdim)
    st = active_strip()
    if st is not None:
        s = s.contiguous()
        st.all_reduce(s, "reduce_bytes")
    return s


def strip_mean_hw(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """x.mean((2, 3)) of the whole map; outside `spatial()` exactly that.
    On a strip the f32 sum over every strip divided by the whole map's
    pixels and cast once to x's dtype (bf16 agrees with the whole map's
    mean to one rounding)."""
    st = active_strip()
    if st is None:
        return x.mean((2, 3), keepdim=keepdim)
    n = st.level(x.shape[2]).height * x.shape[3]
    return (strip_sum_hw(x, keepdim) / n).to(x.dtype)


def strip_amax_hw(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """x.amax((2, 3)) of the whole map; outside `spatial()` exactly that.
    On a strip the strips' maxima, max-all-reduced (in f32, exact)."""
    m = x.amax((2, 3), keepdim=keepdim)
    st = active_strip()
    if st is None:
        return m
    m = m.to(_reduce_dtype(x)).contiguous()
    st.all_reduce(m, "reduce_bytes", op=dist.ReduceOp.MAX)
    return m.to(x.dtype)


def strip_mean_h(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x.mean(dim) over the whole map's rows, `dim` the rows' axis: the
    strips' f32 sums all-reduced, divided by the whole map's rows, cast once."""
    st = active_strip()
    n = st.level(x.shape[dim]).height
    s = x.to(_reduce_dtype(x)).sum(dim).contiguous()
    st.all_reduce(s, "reduce_bytes")
    return (s / n).to(x.dtype)


def check_aligned(xs: Sequence[torch.Tensor], gain: int = 1) -> None:
    """On a strip: the inputs of an elementwise or channel fusion hold the
    same strip (the same rows), and a space-to-depth by `gain` starts on a
    multiple of it."""
    st = active_strip()
    if st is None:
        return
    rows = {x.shape[2] for x in xs}
    if len(rows) != 1:
        raise ValueError(f"fused maps hold strips of {sorted(rows)} rows")
    lv = st.level(rows.pop())
    if lv.start % gain or (lv.stop - lv.start) % gain:
        raise ValueError(f"a space-to-depth by {gain} on a strip of rows [{lv.start}, {lv.stop})")


def conv2d(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], stride, padding, dilation,
           groups: int) -> torch.Tensor:
    """F.conv2d on the active strip: the rows of the window above and below
    the strip (conv_halo) come from its neighbours, zeros past the image's
    edges as the conv pads, and the conv runs with H padding 0."""
    above, below = conv_halo(weight.shape[2], stride[0], padding[0], dilation[0])
    y = torch.nn.functional.conv2d(halo_rows(x, above, below), weight, bias, stride, (0, padding[1]), dilation,
                                   groups)
    if y.shape[2] * stride[0] != x.shape[2]:
        raise ValueError(f"a strip of {x.shape[2]} rows gave {y.shape[2]} rows at stride {stride[0]}")
    return y


def conv_halo(k: int, stride: int, pad: int, dilation: int = 1) -> Tuple[int, int]:
    """The rows a strip needs above and below its own for a k-row conv at
    `stride`, `pad`, `dilation`: output row y reads input rows
    y*stride - pad + [0, span), span = dilation*(k - 1) + 1, so a strip of
    input rows [a, b), a and b multiples of the stride, needs [a - pad,
    b - stride - pad + span)."""
    span = dilation * (k - 1) + 1
    return pad, max(span - stride - pad, 0)


def gather_level_outputs(preds: List[torch.Tensor], batch: int) -> List[torch.Tensor]:
    """The head's whole maps of the whole batch [(B, ny, nx, na, no), ...]
    on every rank, from each rank's strip rows of its batch slice: every
    level in one zeroed buffer, each rank's block written by the slice's
    ranks, summed as bytes over the world (one collective)."""
    st = active_strip()
    b = preds[0].shape[0]
    if batch != b * st.slices:
        raise ValueError(f"a batch of {batch} over {st.slices} slices of {b}")
    dtypes = {p.dtype for p in preds}
    if len(dtypes) != 1:
        raise TypeError(f"head levels of dtypes {sorted(map(str, dtypes))}")
    levels = [st.level(p.shape[1]) for p in preds]
    sizes = [batch * lv.height * p[0, 0].numel() for p, lv in zip(preds, levels)]
    flat = preds[0].new_zeros(sum(sizes))
    out, at = [], 0
    for p, lv, n in zip(preds, levels, sizes):
        whole = flat[at:at + n].view(batch, lv.height, *p.shape[2:])
        whole[st.batch_slice * b:(st.batch_slice + 1) * b, lv.start:lv.stop].copy_(p)
        out.append(whole)
        at += n
    st.all_reduce(_as_bytes(flat), "output_bytes", world=True)
    return out
