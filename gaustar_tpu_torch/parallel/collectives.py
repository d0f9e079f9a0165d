"""Differentiable collectives over a process group (the port's own; the JAX
package has them from jax.lax and its AD).

`all_gather` concatenates every rank's tensor along dim 0; its backward is a
sum all_reduce of the cotangent followed by the rank's own slice (each
rank's loss reads the whole gathered tensor). `all_reduce_sum` sums; its
backward is the sum of the cotangents, which every rank holds equal here.
torch.distributed.nn.functional.all_gather is not used: off NCCL its backward
takes all_to_all, which gloo lacks for CUDA tensors.

How the gather moves bytes. It is a sum all_reduce of a zero-filled [D * n]
buffer into which each rank writes its slice, on every backend: D times the
bytes of a gather, exact (x + 0 is x). gloo offers only broadcast and
all_reduce for CUDA tensors, and NCCL refuses two ranks on one card, so
ranks that share a card need this route; the CPU tests and the card's
shared-card phase run it. NCCL's all_gather_into_tensor would move about
half the ring bytes, but no run on separate cards has measured it yet.

`BYTES` counts, per rank, the bytes each call put into a collective (the
buffer's size). With `reset_counters(timed=True)`, `SECONDS` adds up each
collective's host-clock time with the device synchronised before and after
it, so that it holds the collective alone. The synchronisations slow the
step: a timed step's wall is not the untimed step's.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

BYTES = {"all_gather": 0, "all_reduce": 0}
SECONDS = {"all_gather": 0.0, "all_reduce": 0.0}
_TIMED = [False]


def reset_counters(timed: bool = False):
    """Zero BYTES and SECONDS; `timed` switches the per-collective timing."""
    for k in BYTES:
        BYTES[k], SECONDS[k] = 0, 0.0
    _TIMED[0] = timed


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _sync(x):
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def _reduce(x, group, kind, op=dist.ReduceOp.SUM):
    """In-place all_reduce of x, counted under `kind`."""
    BYTES[kind] += x.numel() * x.element_size()
    if _TIMED[0]:
        _sync(x)
        t0 = time.perf_counter()
    dist.all_reduce(x, op=op, group=group)
    if _TIMED[0]:
        _sync(x)
        SECONDS[kind] += time.perf_counter() - t0
    return x


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    return x if group is None else _reduce(x, group, "all_reduce", op)


def gather_raw(x: torch.Tensor, group) -> torch.Tensor:
    """[D * n, ...] from every rank's [n, ...] (equal n), not differentiable."""
    d = _size(group)
    if d == 1:
        return x
    n = x.shape[0]
    r = _rank(group)
    out = x.new_zeros((d * n, *x.shape[1:]))
    out[r * n:(r + 1) * n] = x
    return _reduce(out, group, "all_gather")


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.n = x.shape[0]
        return gather_raw(x, group)

    @staticmethod
    def backward(ctx, ct):
        ct = _all_reduce(ct.contiguous().clone(), ctx.group)
        r = _rank(ctx.group)
        return ct[r * ctx.n:(r + 1) * ctx.n], None


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable concatenation over the group's ranks along dim 0 (every
    rank passes the same shape)."""
    if _size(group) == 1:
        return x
    return _AllGather.apply(x, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, ct):
        return _all_reduce(ct.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum over the group's ranks."""
    if _size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def gather_varlen(x: torch.Tensor, group) -> tuple[torch.Tensor, list[int]]:
    """(rows of every rank concatenated in rank order, each rank's row count)
    for per-rank row counts that differ: the counts are exchanged first, every
    rank pads to the largest, gathers, and the padding is dropped. Not
    differentiable."""
    d = _size(group)
    if d == 1:
        return x, [x.shape[0]]
    counts = gather_raw(torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device), group).tolist()
    m = max(counts)
    pad = x.new_zeros((m, *x.shape[1:]))
    pad[: x.shape[0]] = x
    full = gather_raw(pad, group)
    rows = [full[i * m:i * m + c] for i, c in enumerate(counts)]
    return torch.cat(rows), counts


def all_reduce_flat(tensors: list[torch.Tensor], group, op=dist.ReduceOp.SUM) -> list[torch.Tensor]:
    """One coalesced all_reduce of several tensors of one dtype (flattened
    into one buffer); returns new tensors of the reduced values."""
    if _size(group) == 1:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce(flat, group, op)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view_as(t))
        i += t.numel()
    return out
