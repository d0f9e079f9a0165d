"""The yardstick of the rooflines: the card's peaks, and the operations and
bytes each piece of the step needs, counted from its inputs alone.

The blend's counts read only a render's pair lists per tile, the image size
and the channels, and the walk that a plain front-to-back composite of those
lists needs up to each pixel's stop (reference/blend.walk). Each input byte
is counted read once and each output byte written once. Float operations
(add, multiply, compare, min, divide, exp one each; weights from the blend's
formulas): every evaluated (pixel, pair) is a test: offsets, power, exp,
alpha, the two cuts (16). An included pair adds, in the forward, the T
update and the channel sums (4 + 2 C); in the backward, T recovery, the
per-channel suffix sums, dL/dalpha and the six geometric gradients (29 + 8
C), and one add per field to sum the tile's pixels (6 + C).
"""

from __future__ import annotations

import torch

from benchmark.reference.blend import PIX, walk

# Published peaks (NVIDIA's data sheet, SXM part, dense): float32 outside the
# tensor cores, and HBM bandwidth; keyed by torch.cuda.get_device_name().
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "bytes_s": 3.35e12},
}
TEST_OPS = 16
# SSIM of one render (3 channels; 5 maps each through an 11-tap separable
# window, zero padded): per pixel, the 9 products, 15 maps x 2 passes x 11
# taps x 2 (multiply, add) and the map's 20 operations a channel in the
# forward; the transposed filters and the same again in the backward.
SSIM_OPS_PER_PIXEL = 2 * (9 + 15 * 2 * 11 * 2 + 3 * 20)
ADAM_OPS_PER_ELEMENT = 12  # two moment updates, bias corrections, sqrt, divide, step
# The program function whose arguments are a render's blend inputs:
# (pair_data, tile_start, tile_count, grid_x, width, height, channels).
BLEND_CAPTURE = ("gaustar_tpu_torch.ops.rasterizer", "blend_raw")
# The blend's kernels, by a part of their names, forward and backward.
BLEND_KERNELS = {"fwd": ("blend_test_kernel", "blend_chain_kernel"),
                 "bwd": ("blend_scan_kernel", "blend_grad_kernel")}


def blend_counts(pair_data, tile_start, tile_count, grid_x: int, width: int, height: int, channels: int) -> dict:
    """{"fwd_ops", "fwd_bytes", "bwd_ops", "bwd_bytes"} of one render's
    blend. pair_data is [6 + C or more, P]: rows x, y, conic A, B, C,
    opacity, features."""
    f = 6 + channels
    feats = pair_data[:f].T.contiguous()
    w = walk(feats, tile_start.long(), tile_count.long(), grid_x, width, height, channels)
    tiles = tile_start.shape[0]
    backed = int((w["back_reach"] > 0).sum())
    included = int(w["included"].sum())
    return {
        "fwd_ops": TEST_OPS * int(w["tested"].sum()) + (4 + 2 * channels) * included,
        # pair fields up to each tile's reach, the tile ranges, and the
        # composited channels, final T and each pixel's last pair written
        "fwd_bytes": 4 * f * int(w["reach"].sum()) + 8 * tiles + 4 * PIX * (channels + 2) * tiles,
        "bwd_ops": TEST_OPS * int(w["back_tested"].sum()) + (29 + 8 * channels + f + channels) * included,
        # pair fields read and their gradients written up to each tile's
        # back reach; final T, last pair and the cotangents of the channels
        # and of T read
        "bwd_bytes": 8 * f * int(w["back_reach"].sum()) + 8 * backed + 4 * PIX * (channels + 3) * backed,
    }


def bound_s(ops: float, nbytes: float, peak: dict) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(ops / peak["f32_flops"], nbytes / peak["bytes_s"])


def blend_kernel_s(trace, side: str) -> float:
    """Summed device seconds of the traced window's blend kernels of one
    side ("fwd" or "bwd")."""
    lo, hi = trace.window
    return sum(b - a for name, a, b in trace.kernels
               if lo <= a < hi and any(k in name for k in BLEND_KERNELS[side]))


@torch.no_grad()
def blend_calls(trace) -> list:
    """blend_counts of every blend call the traced window captured (memoized
    on the trace). Where the trace records kernels, the calls and the
    kernels have to agree: blend kernels that ran with no call captured
    (the program reached them by another path than BLEND_CAPTURE), or calls
    captured with no blend kernel of a side run (the kernels were renamed),
    raise, so that the rooflines fail the run rather than fall silent."""
    if "blend_counts" not in trace.memo:
        calls = trace.captures.get(BLEND_CAPTURE, [])
        if trace.kernels:
            ran = {side: blend_kernel_s(trace, side) > 0 for side in BLEND_KERNELS}
            if not calls and any(ran.values()):
                raise RuntimeError(f"blend kernels ran in the traced window but no call of {BLEND_CAPTURE} was "
                                   f"captured: the program reaches them by another path")
            if calls and not all(ran.values()):
                raise RuntimeError(f"{len(calls)} blend calls were captured but no kernel named as in "
                                   f"{BLEND_KERNELS} ran for {[k for k, v in ran.items() if not v]}")
        trace.memo["blend_counts"] = [blend_counts(*args[:7]) for args, _ in calls]
    return trace.memo["blend_counts"]


def roofline(run, side: str):
    """One side's share of its roofline: the summed bound time of the
    traced window's blend calls over the summed device time of that side's
    kernels; None where nothing was read (no kernel recorded, as on the
    CPU, or a card with no peak in PEAKS)."""
    peak = PEAKS.get(run.device_kind)
    calls = blend_calls(run.trace)
    device_s = blend_kernel_s(run.trace, side)
    if peak is None or not calls or device_s <= 0:
        return None
    return 100.0 * sum(bound_s(c[f"{side}_ops"], c[f"{side}_bytes"], peak) for c in calls) / device_s
