"""Static-topology row gather with a precomputed segment-sum backward
(counterpart of gaustar_tpu/ops/segment.py).

The mesh gathers of the refine step, `verts[faces]` and `normals[adj_faces]`,
have index arrays that change only when the mesh does. Their tables
(order = argsort(idx), offsets = segment bounds) are built once per topology,
and the backward is a segment sum over the cotangent rows grouped by
destination: deterministic, with no atomics.
"""

from __future__ import annotations

import numpy as np
import torch

from gaustar_tpu_torch.utils.general import resolve_device


def gather_tables(idx, n_src: int, device="cuda"):
    """Backward tables for `gather_rows`: (order [M] int64, offsets
    [n_src + 1] int64) for the flat gather index array `idx`."""
    idx = np.asarray(idx).reshape(-1)
    order = np.argsort(idx, kind="stable")
    offsets = np.searchsorted(idx[order], np.arange(n_src + 1))
    dev = resolve_device(device)
    return (
        torch.as_tensor(order, dtype=torch.int64, device=dev),
        torch.as_tensor(offsets, dtype=torch.int64, device=dev),
    )


class _GatherRowsStatic(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, idx, order, offsets):
        ctx.save_for_backward(order, offsets)
        return src[idx]

    @staticmethod
    def backward(ctx, ct):
        order, offsets = ctx.saved_tensors
        d_src = torch.segment_reduce(ct[order], "sum", offsets=offsets, axis=0, unsafe=True)
        return d_src, None, None, None


def gather_rows(src, idx, tables=None):
    """`src[idx]` ([M, C] rows). With `tables` from `gather_tables` the
    backward is the static segment sum; without, PyTorch's index backward."""
    if tables is None:
        return src[idx]
    order, offsets = tables
    return _GatherRowsStatic.apply(src, idx, order, offsets)
