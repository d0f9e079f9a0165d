"""Tile binning: (gaussian, tile) pair expansion, depth sort, per-tile ranges
(counterpart of gaustar_tpu/ops/binning.py; the CUDA rasterizer's
rasterizer_impl.cu:197-338 duplicateWithKeys -> radix sort ->
identifyTileRanges).

The pair order is the JAX package's and the reference's: gaussians are ranked
by a stable sort on (is-culled, depth), each emits its pairs in rect row-major
order, and a stable sort by tile keeps depth order inside every tile.

Buffers are sized EXACTLY, as the CUDA reference sizes them: the pair count is
read on the host once per render, and the pair list is compact,
`tile_start[t] .. tile_start[t] + tile_count[t]`. That read is one of the five
host syncs of a render; the other four copy host-built constants to the card:
`Camera.view`'s bottom row, read three times (twice in preprocess, once for
the depth channel), and the background colour in ops/rasterizer.py. The JAX
package's static capacities, overflow auto-retry and chunk-aligned padded
segments are TPU choices that the port does not need.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gaustar_tpu_torch.ops.projection import Gaussians2D
from gaustar_tpu_torch.utils import profiling


class BinnedPairs(NamedTuple):
    gauss_idx: torch.Tensor  # [P] int64 depth-RANK gaussian of each tile-sorted pair
    depth_order: torch.Tensor  # [N] int64 rank -> original gaussian id
    depth_order_inv: torch.Tensor  # [N] int64 original id -> rank
    pair_emit: torch.Tensor  # [P] int64 emission index of each tile-sorted pair
    rank_pairs: torch.Tensor  # [N] int64 pairs emitted by each rank (emission segments)
    tile_start: torch.Tensor  # [T] int32 first pair of each tile
    tile_count: torch.Tensor  # [T] int32 pairs of each tile
    num_pairs: int


def bin_gaussians(g: Gaussians2D, grid_x: int, grid_y: int) -> BinnedPairs:
    n = g.mean2d.shape[0]
    dev = g.mean2d.device
    n_tiles = grid_x * grid_y
    touched_all = g.tiles_touched.to(torch.int64)

    # Stable lexicographic sort on (is-culled, depth): sort by the minor key,
    # then stably by the major key. Ties keep the gaussian index order.
    by_depth = torch.sort(g.depth.detach(), stable=True).indices
    culled = (touched_all == 0).to(torch.int8)[by_depth]
    order = by_depth[torch.sort(culled, stable=True).indices]
    order_inv = torch.empty_like(order)
    order_inv[order] = torch.arange(n, device=dev)

    touched = touched_all[order]
    num_pairs = int(touched.sum())  # a host sync: the pair buffers' size
    profiling.count("pairs", num_pairs)
    profiling.count("renders")
    gi, tile = expand_pairs(touched, g.rect_min[order], g.rect_max[order], grid_x, num_pairs)

    tile_sorted, pair_emit = torch.sort(tile, stable=True)
    gauss_idx = gi[pair_emit]
    bounds = torch.searchsorted(tile_sorted, torch.arange(n_tiles + 1, device=dev))
    starts = bounds[:-1]
    counts = bounds[1:] - starts
    return BinnedPairs(
        gauss_idx=gauss_idx,
        depth_order=order,
        depth_order_inv=order_inv,
        pair_emit=pair_emit,
        rank_pairs=touched,
        tile_start=starts.to(torch.int32),
        tile_count=counts.to(torch.int32),
        num_pairs=num_pairs,
    )


def expand_pairs(touched, rect_min, rect_max, grid_x: int, num_pairs: int):
    """(gaussian [P], tile [P]) int64 of every (gaussian, tile) pair: each
    gaussian in turn emits the tiles of its rect in row-major order.
    `touched` [N] int64 sums to num_pairs."""
    dev = touched.device
    offsets = torch.cumsum(touched, 0) - touched
    gi = torch.repeat_interleave(torch.arange(touched.shape[0], device=dev), touched, output_size=num_pairs)
    k = torch.arange(num_pairs, device=dev) - offsets[gi]
    rmin = rect_min.to(torch.int64)[gi]
    rw = (rect_max[:, 0] - rect_min[:, 0]).to(torch.int64)[gi]
    dy = torch.div(k, rw, rounding_mode="floor")
    dx = k - dy * rw
    return gi, (rmin[:, 1] + dy) * grid_x + (rmin[:, 0] + dx)


class _PermuteRows(torch.autograd.Function):
    """src[perm] whose backward is the GATHER ct[inv_perm] (a permutation's
    transpose), as gaustar_tpu binning._permute_rows."""

    @staticmethod
    def forward(ctx, src, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return src[perm]

    @staticmethod
    def backward(ctx, ct):
        (inv_perm,) = ctx.saved_tensors
        return ct[inv_perm], None, None


class _GatherRowsSoA(torch.autograd.Function):
    """src [N, F] row gather -> [F, P] SoA; backward is the per-rank segment sum
    of the pair-slot cotangents (gaustar_tpu binning._gather_rows_soa).

    The cotangent columns are first put back in emission order (a
    permutation), where every rank's pairs are one contiguous segment, then
    summed per segment. No atomics, so the sum is deterministic."""

    @staticmethod
    def forward(ctx, src, gauss_idx, pair_emit, rank_pairs):
        ctx.save_for_backward(pair_emit, rank_pairs)
        return src[gauss_idx].T.contiguous()

    @staticmethod
    def backward(ctx, ct):
        with profiling.span("render.gather_bwd"):
            pair_emit, rank_pairs = ctx.saved_tensors
            ct_emit = torch.empty((ct.shape[1], ct.shape[0]), dtype=ct.dtype, device=ct.device)
            ct_emit[pair_emit] = ct.T
            d_src = torch.segment_reduce(ct_emit, "sum", lengths=rank_pairs, axis=0, unsafe=True)
        return d_src, None, None, None


def gather_pair_data(g: Gaussians2D, binned: BinnedPairs) -> torch.Tensor:
    """Differentiable gather of per-pair blend data, SoA [6 + C, P].

    Rows (read by the blend kernels): 0 mean2d.x, 1 mean2d.y, 2 conic.A,
    3 conic.B, 4 conic.C, 5 opacity, 6.. features. The JAX package pads the
    rows to 16 for TPU DMA alignment; the port keeps only the real ones."""
    src = torch.cat([g.mean2d, g.conic, g.opacity[:, None], g.color], dim=-1)
    src = _PermuteRows.apply(src, binned.depth_order, binned.depth_order_inv)
    return _GatherRowsSoA.apply(src, binned.gauss_idx, binned.pair_emit, binned.rank_pairs)
