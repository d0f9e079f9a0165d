"""Front-to-back alpha compositing of per-tile pair lists, in plain PyTorch.

The semantics are 3D Gaussian splatting's (renderCUDA): for each pixel and
each pair of its 16x16 tile's list in order, power = -1/2 (A dx^2 + C dy^2)
- B dx dy and alpha = min(0.99, opacity e^power); a pair is skipped where
power > 0 or alpha < 1/255, and the pixel stops before the first pair with
T (1 - alpha) < 1e-4. The gradient of alpha passes the 0.99 clamp straight
through, as the rasterizer's backward does.

Written in closed form: each chunk of tiles is padded to its longest list and
evaluated as [tiles, pairs, 256] tensors with cumulative products, so that
plain autograd gives the gradients. The backward recomputes each chunk
(`TileBlend`), which keeps memory to one chunk's graph. `walk` gives, from the
same evaluation, how far a plain composite has to walk each pixel's list,
which the benchmark's bound of the blend counts.
"""

from __future__ import annotations

import torch

TILE = 16
PIX = TILE * TILE
CHUNK_ELEMS = 1 << 23  # (tile, pair, pixel) values a chunk evaluates at once


def clamp_alpha(alpha):
    """min(0.99, alpha), its gradient passed straight through."""
    return torch.minimum(alpha, alpha.new_full((), 0.99)).detach() + (alpha - alpha.detach())


def chunks(tile_count, limit: int = CHUNK_ELEMS):
    """[(tile ids, K)]: the non-empty tiles in decreasing list length, cut
    into chunks of at most `limit` (tile, position, pixel) values; K is the
    chunk's longest list."""
    ids = torch.nonzero(tile_count > 0).flatten()
    if ids.numel() == 0:
        return []
    order = torch.sort(tile_count[ids], descending=True, stable=True).indices
    ids = ids[order]
    counts = tile_count[ids].tolist()
    out, i = [], 0
    while i < len(counts):
        k = counts[i]
        m = max(1, limit // (k * PIX))
        out.append((ids[i:i + m], k))
        i += m
    return out


def tile_pixels(ids, grid_x: int, width: int, height: int):
    """(px, py, inside) [m, 256] of the tiles `ids` of a grid_x-wide grid."""
    p = torch.arange(PIX, device=ids.device)
    px = ((ids % grid_x)[:, None] * TILE + p % TILE).to(torch.float32)
    py = ((ids // grid_x)[:, None] * TILE + p // TILE).to(torch.float32)
    return px, py, (px < width) & (py < height)


def gather(feats, tile_start, tile_count, ids, k: int):
    """(slot [m, K], valid [m, K]): the pair rows of each tile's list,
    padded to K with the tile's last row."""
    pos = torch.arange(k, device=feats.device)
    start, count = tile_start[ids][:, None], tile_count[ids][:, None]
    return start + torch.minimum(pos, count - 1), pos < count


def composite(f, valid, px, py, inside, channels: int):
    """Closed-form composite of one chunk. f [m, K, 6 + C] pair fields
    (x, y, A, B, C, opacity, features). Returns (colour [m, C, 256], final
    T [m, 256], contrib, flag, included), the last three [m, K, 256]."""
    dx = f[..., 0:1] - px[:, None, :]
    dy = f[..., 1:2] - py[:, None, :]
    power = -0.5 * (f[..., 2:3] * dx * dx + f[..., 4:5] * dy * dy) - f[..., 3:4] * dx * dy
    alpha = clamp_alpha(f[..., 5:6] * torch.exp(power))
    contrib = (power <= 0.0) & (alpha >= 1.0 / 255.0) & valid[..., None] & inside[:, None, :]
    a0 = torch.where(contrib, alpha, torch.zeros_like(alpha))
    one_m = 1.0 - a0
    cp = torch.cumprod(one_m, dim=1)
    t_tilde = torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)
    flag = contrib & (t_tilde * one_m < 1e-4)
    stopped = torch.cumsum(flag.to(torch.int32), dim=1) > 0
    included = contrib & ~stopped
    a_eff = torch.where(included, a0, torch.zeros_like(a0))
    cp2 = torch.cumprod(1.0 - a_eff, dim=1)
    t_before = torch.cat([torch.ones_like(cp2[:, :1]), cp2[:, :-1]], dim=1)
    w = a_eff * t_before  # [m, K, 256]
    colour = torch.stack([(w * f[..., 6 + c:7 + c]).sum(1) for c in range(channels)], dim=1)
    return colour, cp2[:, -1], contrib, flag, included


class TileBlend(torch.autograd.Function):
    """[T, C + 1, 256] per tile: the composited features, then final T.
    Differentiable in `feats` [P, 6 + C]."""

    @staticmethod
    def forward(ctx, feats, tile_start, tile_count, grid_x, width, height, channels):
        n_tiles = tile_start.shape[0]
        out = feats.new_zeros((n_tiles, channels + 1, PIX))
        out[:, channels] = 1.0
        plan = chunks(tile_count)
        for ids, k in plan:
            slot, valid = gather(feats, tile_start, tile_count, ids, k)
            px, py, inside = tile_pixels(ids, grid_x, width, height)
            colour, t_final, *_ = composite(feats[slot], valid, px, py, inside, channels)
            out[ids, :channels] = colour
            out[ids, channels] = t_final
        ctx.save_for_backward(feats, tile_start, tile_count)
        ctx.meta = (plan, grid_x, width, height, channels)
        return out

    @staticmethod
    def backward(ctx, g_out):
        feats, tile_start, tile_count = ctx.saved_tensors
        plan, grid_x, width, height, channels = ctx.meta
        grads = torch.zeros_like(feats)
        for ids, k in plan:
            slot, valid = gather(feats, tile_start, tile_count, ids, k)
            px, py, inside = tile_pixels(ids, grid_x, width, height)
            with torch.enable_grad():
                f = feats.detach()[slot].requires_grad_()
                colour, t_final, *_ = composite(f, valid, px, py, inside, channels)
                g = g_out[ids]
                (gf,) = torch.autograd.grad([colour, t_final], [f], [g[:, :channels], g[:, channels]])
            grads.index_add_(0, slot[valid], gf[valid])
        return grads, None, None, None, None, None, None


@torch.no_grad()
def walk(feats, tile_start, tile_count, grid_x: int, width: int, height: int, channels: int):
    """What a plain front-to-back composite of these lists has to do, per
    tile [T] (int64): `tested` (pixel, pair) evaluations up to each pixel's
    stop or its list's end, `included` pairs, `reach` the list prefix some
    pixel tests, `back_tested` the (pixel, pair) evaluations of a back-to-
    front walk from each pixel's last included pair, and `back_reach` the
    longest such walk."""
    n_tiles = tile_start.shape[0]
    out = {key: torch.zeros(n_tiles, dtype=torch.int64, device=feats.device)
           for key in ("tested", "included", "reach", "back_tested", "back_reach")}
    for ids, k in chunks(tile_count):
        slot, valid = gather(feats, tile_start, tile_count, ids, k)
        px, py, inside = tile_pixels(ids, grid_x, width, height)
        _, _, _, flag, included = composite(feats[slot], valid, px, py, inside, channels)
        pos = torch.arange(1, k + 1, device=feats.device)[None, :, None]
        count = tile_count[ids].to(torch.int64)[:, None]
        stop_at = torch.where(flag, pos, torch.full_like(pos, k + 1)).amin(dim=1)  # [m, 256]
        fwd = torch.where(inside, torch.minimum(stop_at, count), torch.zeros_like(stop_at))
        back = torch.where(included, pos, torch.zeros_like(pos)).amax(dim=1)
        out["tested"][ids] = fwd.sum(1)
        out["included"][ids] = included.sum((1, 2))
        out["reach"][ids] = fwd.amax(1)
        out["back_tested"][ids] = back.sum(1)
        out["back_reach"][ids] = back.amax(1)
    return out
