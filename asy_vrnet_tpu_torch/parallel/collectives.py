"""Global reductions over the "data" group of a parallel step.

Under GSPMD the JAX package's train step is one program over the global
batch, so every sum, mean, min or max over the batch axis is global: its
BatchNorm is a SyncBatchNorm, its radar gate min-maxes the whole batch, its
losses divide by global counts.  The port runs one process per rank, each
holding B/n contiguous rows of the batch; the functions here make those
reductions global.  A parallel step (`parallel/mesh.py`) names the group
with `data_group`; outside one, each function is the plain local reduction
and adds no device operation.

Two sums, by what consumes the result:
  - `global_sums`: every rank computes the same thing from it (a loss from
    its global sums).  The gradient each rank receives for the sum is then
    the whole one, and the backward passes it on unchanged.
  - `synced_sums`: each rank applies it to its own rows (BatchNorm's
    moments).  Each rank's gradient for it is a part, and the backward sums
    the parts over the group, as SyncBatchNorm's does.
With every loss computed alike on every rank, the model's gradients are
parts whose sum over the ranks is the global batch's gradient
(`all_reduce_grads`); the gradient of a value every rank holds alike (the
uncertainty log-variance) is whole on each rank and is not summed.

The group is process-wide, not per thread: the autograd engine's device
threads run the backward and the rematerialised spans' recomputes
(`models/remat.py`), which reduce again, in the same order on every rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Iterable, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The ranks that split one batch: the process group, this rank's index
    in it, and its size."""

    group: Any
    rank: int
    size: int


_ACTIVE: Optional[DataGroup] = None

# all-reduce calls issued (forward and backward); with `timed` on, the CUDA
# event pairs around them on the issuing stream
CALLS = {"all_reduce": 0}
_EVENTS: Optional[list] = None


def active() -> Optional[DataGroup]:
    return _ACTIVE


@contextlib.contextmanager
def data_group(group: Optional[DataGroup]):
    """Reduce over `group` (None: locally) while the block runs."""
    global _ACTIVE
    old, _ACTIVE = _ACTIVE, group
    try:
        yield
    finally:
        _ACTIVE = old


@contextlib.contextmanager
def timed(events: list):
    """Append (start, end) CUDA events around each all-reduce of a CUDA
    tensor issued while the block runs."""
    global _EVENTS
    old, _EVENTS = _EVENTS, events
    try:
        yield
    finally:
        _EVENTS = old


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    CALLS["all_reduce"] += 1
    if _EVENTS is None or not t.is_cuda:
        dist.all_reduce(t, op=op, group=group)
        return t
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    dist.all_reduce(t, op=op, group=group)
    end.record()
    _EVENTS.append((start, end))
    return t


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """In-place sum over the group of a tensor that carries no gradient."""
    g = _ACTIVE
    return t if g is None else _all_reduce(t, dist.ReduceOp.SUM, g.group)


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                           dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _SyncedSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(memory_format=torch.contiguous_format),
                           dist.ReduceOp.SUM, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(memory_format=torch.contiguous_format),
                           dist.ReduceOp.SUM, ctx.group), None


def global_sums(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Sums over the group of values of one shape that every rank then uses
    alike (one all-reduce); locally the values themselves."""
    g = _ACTIVE
    if g is None:
        return xs
    return _GlobalSum.apply(torch.stack(xs), g.group).unbind(0)


def synced_sums(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Sums over the group of values of one shape that each rank applies to
    its own rows (one all-reduce each way); locally the values themselves."""
    g = _ACTIVE
    if g is None:
        return xs
    return _SyncedSum.apply(torch.stack(xs), g.group).unbind(0)


class _GlobalMinMax(torch.autograd.Function):
    """(min, max) of x over the group.  Forward: one MAX all-reduce of
    (-min, max) in f32 (exact for bf16 and f32 values).  Backward: torch's
    rule for a full min() / max(), over the group: each extreme's gradient
    (summed over the ranks, whose consumers are their own rows) is split
    evenly over every element that holds it, on whichever rank; one SUM
    all-reduce of the two gradients and the two tie counts."""

    @staticmethod
    def forward(ctx, x, group):
        ext = torch.stack([-x.min(), x.max()]).float()
        _all_reduce(ext, dist.ReduceOp.MAX, group)
        lo, hi = (-ext[0]).to(x.dtype), ext[1].to(x.dtype)
        ctx.save_for_backward(x, lo, hi)
        ctx.group = group
        return lo, hi

    @staticmethod
    def backward(ctx, g_lo, g_hi):
        x, lo, hi = ctx.saved_tensors
        m_lo, m_hi = x == lo, x == hi
        buf = torch.stack([g_lo.double(), g_hi.double(), m_lo.sum().double(),
                           m_hi.sum().double()])
        _all_reduce(buf, dist.ReduceOp.SUM, ctx.group)
        g_lo, g_hi = buf[0].to(x.dtype), buf[1].to(x.dtype)
        n_lo, n_hi = buf[2].long(), buf[3].long()
        return m_lo * (g_lo / n_lo) + m_hi * (g_hi / n_hi), None


def min_max(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(min, max) of the whole tensor over the group (locally: x.min(),
    x.max())."""
    g = _ACTIVE
    if g is None:
        return x.min(), x.max()
    return _GlobalMinMax.apply(x, g.group)


def draw_rows(draw: Callable[[tuple], torch.Tensor], shape) -> torch.Tensor:
    """draw(shape) for this rank's rows: over the group, the global batch's
    draw (shape[0] * size rows) and this rank's contiguous rows of it, so
    every rank's generator advances alike and the rows equal one process's
    draw for the whole batch."""
    g = _ACTIVE
    if g is None:
        return draw(tuple(shape))
    b = shape[0]
    return draw((b * g.size, *shape[1:]))[g.rank * b:(g.rank + 1) * b]


def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Sum the parameters' gradients (f32, on one device) over the group in
    place, as one flat all-reduce; parameters without a gradient are left
    out (every rank runs the same graph, so they are the same ones
    everywhere)."""
    g = _ACTIVE
    if g is None:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = torch._utils._flatten_dense_tensors(grads)
    _all_reduce(flat, dist.ReduceOp.SUM, g.group)
    for t, r in zip(grads, torch._utils._unflatten_dense_tensors(flat, grads)):
        t.copy_(r)
