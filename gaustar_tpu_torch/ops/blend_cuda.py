"""Tile blend forward and backward: the CUDA kernels for Hopper and their
plain PyTorch versions (counterpart of gaustar_tpu/ops/blend_pallas.py).

Inputs, shared by every function here:
  pair_data  [F, P] float32 SoA rows 0 x, 1 y, 2-4 conic A/B/C, 5 opacity,
             6.. features (F >= 6 + channels; ops/binning.gather_pair_data);
  tile_start, tile_count  [T] int32: tile t owns pairs start .. start+count,
             front to back;
  tile_base  the image tile of the call's tile 0 (default 0): tile t's
             pixels are those of tile t + tile_base of the grid_x-wide
             grid, so that a strip of an image blends on its own (the JAX
             package's blend_tiles_pallas_base; parallel/gauss2d.py);
  the raw state [T, 8, 256] float32 of the forward, as the JAX kernel's:
             rows 0-2 colour, 3 final T, 4 n_contrib (1-based list position
             of the last included pair), 5 done, 6 channel 3 (fused depth),
             7 zero. Empty tiles hold colour 0, T 1, n_contrib 0.

The blend (forward.cu:261-374): power = -1/2 (A dx^2 + C dy^2) - B dx dy,
alpha = min(0.99, op e^power), a pair is skipped if power > 0 or
alpha < 1/255, and the pixel stops before the first pair with
T (1 - alpha) < 1e-4. The backward (backward.cu:400-557) walks each pixel's
included pairs back to front, recovering T as T / (1 - alpha) from the saved
final T, and returns per-pair-slot gradients [F, P]; d alpha / d G ignores the
0.99 clamp. The final-T cotangent (row 3) adds -(T_final / (1 - alpha)) dT to
dL/dalpha: the background is composited outside the blend, so this is how its
gradient reaches the gaussians.

`blend_raw` is the autograd.Function boundary, the same as the JAX custom VJP:
differentiable in pair_data only. On CUDA tensors it launches the kernels
(csrc/blend_fwd.cu, csrc/blend_bwd.cu) and never falls back; on CPU tensors
it runs the plain versions, which is how the CPU tests run. On the card the
forward's test bits are kept for the backward, which runs no test of its own.

The plain versions walk the pair positions in a Python loop, vectorized over
tiles and pixels. Each step rounds exactly as the kernel's per-pixel loop does
(the kernels are built without FMA contraction), so the discrete decisions,
and `n_contrib`, agree exactly; only the per-slot sums over 256 pixels are
taken in another order. The tiles are walked in decreasing pair count, so
the tiles still walking at a step are a prefix of them and each step works
on that prefix alone; the pairs of up to CHUNK steps are evaluated in one
batch (at most CHUNK_ELEMS (tile, pair, pixel) values), and only the
recurrences run one step at a time.
"""

from __future__ import annotations

import bisect
import ctypes
from typing import NamedTuple

import torch

from gaustar_tpu_torch.ops import _build
from gaustar_tpu_torch.ops.projection import TILE
from gaustar_tpu_torch.ops.rasterizer_ref import clamp_alpha_ste
from gaustar_tpu_torch.utils import profiling

PIX = TILE * TILE
STATE_ROWS = 8
CHUNK = 32  # pair positions a plain blend evaluates in one batch
CHUNK_ELEMS = 1 << 22

def state_row(ch: int) -> int:
    """Raw-state row of blend channel `ch` (channel 3 rides row 6)."""
    return ch if ch < 3 else 6


def _check_inputs(pair_data, tile_start, tile_count, channels):
    if channels not in (3, 4):
        raise ValueError(f"blend supports 3 or 4 channels, got {channels}")
    if pair_data.dtype != torch.float32 or pair_data.dim() != 2 or pair_data.shape[0] < 6 + channels:
        raise ValueError(f"pair_data must be float32 [>= {6 + channels}, P], got {pair_data.dtype} {tuple(pair_data.shape)}")
    if tile_start.shape != tile_count.shape or tile_start.dim() != 1:
        raise ValueError("tile_start and tile_count must be [T] and equal in shape")


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _tile_pixels(tile_ids, grid_x, tile_base=0):
    tile_ids = tile_ids + tile_base
    flat = torch.arange(PIX, device=tile_ids.device)
    px = ((tile_ids % grid_x)[:, None] * TILE + flat % TILE).to(torch.float32)
    py = ((tile_ids // grid_x)[:, None] * TILE + flat // TILE).to(torch.float32)
    return px, py


def _active_tiles(tile_start, tile_count):
    ids = torch.nonzero(tile_count > 0).flatten()
    return ids, tile_start[ids].to(torch.int64), tile_count[ids].to(torch.int64)


def _tiles_by(tile_start, tile_count, key):
    """_active_tiles in decreasing `key` [T] (ties in tile order), and the
    key of each, negated, as an ascending host list."""
    ids, start, count = _active_tiles(tile_start, tile_count)
    order = torch.sort(key[ids], descending=True, stable=True).indices
    return ids[order], start[order], count[order], (-key[ids[order]]).tolist()


def _batch(neg_key: list, k: int) -> tuple[int, int]:
    """(m, K): the tiles whose key exceeds k - K (a prefix), and K pair
    positions below or from k (at most CHUNK, and at most CHUNK_ELEMS
    values over the m tiles)."""
    steps = min(CHUNK, k)
    while True:
        m = bisect.bisect_left(neg_key, -(k - steps))
        if steps == 1 or m * steps * PIX <= CHUNK_ELEMS:
            return m, steps
        steps = max(1, CHUNK_ELEMS // (m * PIX))


def _pair_at(pair_data, start, count, k: int):
    """Fields [F, Tn] of each tile's k-th pair, and whether it exists [Tn]."""
    d, valid = _pairs_at(pair_data, start, count, torch.tensor([k], device=start.device))
    return d[..., 0], valid[:, 0]


def _pairs_at(pair_data, start, count, ks):
    """Fields [F, Tn, K] of each tile's pairs at positions `ks` [K], and
    whether each exists [Tn, K]."""
    valid = count[:, None] > ks
    slot = start[:, None] + torch.clamp(torch.minimum(count[:, None] - 1, ks), min=0)
    return pair_data[:, slot], valid


def _eval_pair(d, px, py):
    """The pairs' power, alpha and skip test at the pixels: fields d [F, ...]
    against pixel positions that broadcast with d[0][..., None]."""
    dx = d[0][..., None] - px
    dy = d[1][..., None] - py
    A, B, C = d[2][..., None], d[3][..., None], d[4][..., None]
    op = d[5][..., None]
    power = -0.5 * (A * dx * dx + C * dy * dy) - B * dx * dy
    g = torch.exp(power)
    alpha = clamp_alpha_ste(op * g)
    contrib = (power <= 0.0) & (alpha >= 1.0 / 255.0)
    return alpha, contrib, g, dx, dy


def blend_fwd_plain(pair_data, tile_start, tile_count, grid_x, width, height, channels, tile_base=0):
    """Forward blend -> raw state [T, 8, 256]. Differentiable by autograd
    (with the straight-through 0.99 clamp), which the tests use to check
    blend_bwd_plain."""
    _check_inputs(pair_data, tile_start, tile_count, channels)
    n_tiles = tile_start.shape[0]
    empty = torch.zeros((n_tiles, STATE_ROWS, PIX), dtype=torch.float32, device=pair_data.device)
    empty[:, 3] = 1.0
    ids, start, count, neg_count = _tiles_by(tile_start, tile_count, tile_count)
    if ids.numel() == 0:
        return empty
    px, py = _tile_pixels(ids, grid_x, tile_base)
    done = (px >= width) | (py >= height)
    T = torch.ones_like(px)
    col = px.new_zeros((channels,) + px.shape)
    nc = torch.zeros_like(px)
    ended = []  # the final state of the tiles whose lists ended, in tile order
    k = 0
    while k < -neg_count[0]:
        m = bisect.bisect_left(neg_count, -k)  # the tiles with pairs at k
        if m < T.shape[0]:
            ended.insert(0, (col[:, m:], T[m:], nc[m:], done[m:]))
            col, T, nc, done = col[:, :m], T[:m], nc[:m], done[:m]
        steps = max(1, min(CHUNK, -neg_count[0] - k, CHUNK_ELEMS // (m * PIX)))
        ks = torch.arange(k, k + steps, device=px.device)
        d, valid = _pairs_at(pair_data, start[:m], count[:m], ks)
        alpha, contrib, _, _, _ = _eval_pair(d, px[:m, None], py[:m, None])  # [m, K, 256]
        contrib = contrib & valid[..., None]
        one_minus = 1.0 - alpha
        weighted = d[6:6 + channels][..., None] * alpha  # [C, m, K, 256]
        for j in range(len(ks)):
            inc = contrib[:, j] & ~done
            test_t = T * one_minus[:, j]
            stop = inc & (test_t < 1e-4)
            inc = inc & ~stop
            done = done | stop
            col = torch.where(inc, col + weighted[:, :, j] * T, col)
            T = torch.where(inc, test_t, T)
            nc = torch.where(inc, float(k + j + 1), nc)
        k += len(ks)
    col, T, nc, done = (torch.cat(parts, dim=1 if i == 0 else 0)
                        for i, parts in enumerate(zip((col, T, nc, done), *ended)))
    zero = torch.zeros_like(T)
    rows = [col[0], col[1], col[2], T, nc, done.to(torch.float32), col[3] if channels == 4 else zero, zero]
    return empty.index_put((ids,), torch.stack(rows, dim=1))


def blend_bwd_plain(pair_data, tile_start, tile_count, grid_x, width, height, channels, fwd, dout, tile_base=0):
    """Backward blend: per-pair-slot gradients [F, P] from the forward's raw
    state and its cotangent (rows 0-3 and 6 are read). The formulas of
    backward.cu written out (no autograd); slots never walked stay zero."""
    _check_inputs(pair_data, tile_start, tile_count, channels)
    grads = torch.zeros_like(pair_data)
    # Tiles in decreasing n_contrib: walking back to front from position
    # k_max - 1, the tiles that have begun are a prefix of them.
    ids, start, count, neg_walked = _tiles_by(tile_start, tile_count, fwd[:, 4].amax(dim=1).to(torch.int64))
    if ids.numel() == 0 or neg_walked[0] == 0:
        return grads
    px, py = _tile_pixels(ids, grid_x, tile_base)
    t_final = fwd[ids, 3]
    nc = fwd[ids, 4]
    d_t = dout[ids, 3]
    d_c = torch.stack([dout[ids, state_row(ch)] for ch in range(channels)])  # [C, Tn, 256]
    zero = torch.zeros_like(px)
    zeros_c = torch.zeros_like(d_c)
    # The state of the tiles that have begun (a prefix); a tile joins with
    # its final T and nothing accumulated.
    T, acc, last_c, last_alpha = t_final[:0], zeros_c[:, :0], zeros_c[:, :0], zero[:0]
    k_hi = -neg_walked[0]
    while k_hi > 0:
        m, steps = _batch(neg_walked, k_hi)
        T, acc, last_c, last_alpha = (torch.cat([x, y[..., x.shape[-2]:m, :]], dim=-2)
                                      for x, y in ((T, t_final), (acc, zeros_c), (last_c, zeros_c),
                                                   (last_alpha, zero)))
        k_lo = k_hi - steps
        ks = torch.arange(k_lo, k_hi, device=px.device)
        d, valid = _pairs_at(pair_data, start[:m], count[:m], ks)
        alpha, contrib, g, dx, dy = _eval_pair(d, px[:m, None], py[:m, None])  # [m, K, 256]
        contrib = contrib & valid[..., None]
        one_minus = 1.0 - alpha
        feats = d[6:6 + channels][..., None]  # [C, m, K, 1]
        nc_m, t_fin, d_tm, d_cm, zero_m = nc[:m], -t_final[:m], d_t[:m], d_c[:, :m], zero[:m]
        qs, g_feats = [None] * len(ks), [None] * len(ks)
        for j in range(len(ks) - 1, -1, -1):
            inc = contrib[:, j] & (nc_m >= k_lo + j + 1)
            T = torch.where(inc, T / one_minus[:, j], T)
            w = alpha[:, j] * T
            c = feats[:, :, j]
            acc = torch.where(inc, last_alpha * last_c + (1.0 - last_alpha) * acc, acc)
            last_c = torch.where(inc, c.expand_as(last_c), last_c)
            terms = (c - acc) * d_cm
            dl_da = zero_m
            for ch in range(channels):
                dl_da = dl_da + terms[ch]
            g_feats[j] = torch.where(inc, w * d_cm, zero_m)
            dl_da = dl_da * T
            last_alpha = torch.where(inc, alpha[:, j], last_alpha)
            dl_da = dl_da + (t_fin / one_minus[:, j]) * d_tm
            qs[j] = torch.where(inc, g[:, j] * dl_da, zero_m)
        q = torch.stack(qs, dim=1)  # [m, K, 256]
        A, B, C = d[2][..., None], d[3][..., None], d[4][..., None]
        op = d[5][..., None]
        per_pixel = [
            -op * q * (A * dx + B * dy),
            -op * q * (C * dy + B * dx),
            -0.5 * op * q * dx * dx,
            -op * q * dx * dy,
            -0.5 * op * q * dy * dy,
            q,
        ] + list(torch.stack(g_feats, dim=2))
        sums = torch.stack(per_pixel, dim=0).sum(dim=-1)  # [6 + C, m, K]
        grads[: 6 + channels, (start[:m, None] + ks)[valid]] = sums[:, valid]
        k_hi = k_lo
    return grads


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/blend_fwd.cu, csrc/blend_bwd.cu, csrc/blend_common.cuh)
# ---------------------------------------------------------------------------

SEG = 256  # pairs per work item: blend::SEG in csrc/blend_common.cuh
WORD = 32  # pairs per word of test bits


class SplitPlan(NamedTuple):
    """The kernels' work list: each tile's pair list cut into segments of
    `seg` pairs, one work item per (tile, segment).

    ends [3, T] int32: over the tiles, the inclusive cumsums of each tile's
    segments, test-bit words (WORD pairs each) and recorded backward states
    (segments - 1). The other fields bound the totals from the pair count
    alone, so that grids and scratch are sized with no host sync: a tile of
    c > 0 pairs has at most c / seg + 1 segments and c / WORD + 1 words, and
    floor((c - 1) / seg) states."""

    ends: torch.Tensor
    items: int
    words: int
    states: int

    def bits_bytes(self) -> int:
        return 4 * PIX * self.words

    def state_bytes(self, channels: int) -> int:
        return 4 * PIX * (2 + 2 * channels) * self.states


def split_plan(tile_count, num_pairs: int, seg: int = SEG) -> SplitPlan:
    """The work list of tile lists whose counts sum to at most num_pairs. The
    kernels are built for segments of SEG pairs; another `seg` only describes
    a work list, as the CPU tests' emulation of the split uses one."""
    count = tile_count.to(torch.int32)
    nseg = (count + (seg - 1)) // seg
    per_tile = torch.stack([nseg, (count + (WORD - 1)) // WORD, torch.clamp(nseg - 1, min=0)])
    spare = min(count.shape[0], num_pairs)
    return SplitPlan(torch.cumsum(per_tile, 1, dtype=torch.int32), num_pairs // seg + spare,
                     num_pairs // WORD + spare, num_pairs // seg)


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# pair_data, stride, tile_start, tile_count, ends, n_tiles, n_items, seg, grid_x, tile_base
_COMMON_ARGS = [_P, _L, _P, _P, _P, _I, _I, _I, _I, _I]
_FWD_ARGS = _COMMON_ARGS + [_I, _I, _I, _P, _P, _P]  # width, height, channels, bits, out, stream
_BWD_ARGS = _COMMON_ARGS + [_I, _P, _P, _P, _P, _P, _P]  # channels, fwd, dout, bits, states, grads, stream


def _check_cuda(pair_data, tile_start, tile_count, channels, *states):
    _check_inputs(pair_data, tile_start, tile_count, channels)
    dev = pair_data.device
    if dev.type != "cuda":
        raise ValueError("the blend kernels take CUDA tensors")
    if not pair_data.is_contiguous():
        raise ValueError("pair_data must be contiguous")
    for t in (tile_start, tile_count):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError("tile_start / tile_count must be contiguous int32 on the pair_data device")
    n_tiles = tile_start.shape[0]
    for s in states:
        if s.device != dev or s.dtype != torch.float32 or s.shape != (n_tiles, STATE_ROWS, PIX) or not s.is_contiguous():
            raise ValueError(f"blend state must be contiguous float32 [{n_tiles}, {STATE_ROWS}, {PIX}]")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {err}")


def _common_args(pair_data, tile_start, tile_count, plan, grid_x, tile_base):
    return (pair_data.data_ptr(), pair_data.stride(0), tile_start.data_ptr(), tile_count.data_ptr(),
            plan.ends.data_ptr(), tile_start.shape[0], plan.items, SEG, grid_x, int(tile_base))


def blend_fwd_split(pair_data, tile_start, tile_count, grid_x, width, height, channels, tile_base=0):
    """Launch csrc/blend_fwd.cu -> (raw state, split): the test of every
    (pixel, pair), one block per (tile, segment), then each tile's pixels
    composite their set bits. `split` is (plan, test bits), which the
    backward of the same inputs reads (blend_bwd_cuda)."""
    _check_cuda(pair_data, tile_start, tile_count, channels)
    lib = _build.load("blend_fwd", {"blend_fwd": _FWD_ARGS})
    plan = split_plan(tile_count, pair_data.shape[1])
    dev = pair_data.device
    bits = torch.empty((plan.words, PIX), dtype=torch.int32, device=dev)
    out = torch.empty((tile_start.shape[0], STATE_ROWS, PIX), dtype=torch.float32, device=dev)
    err = lib.blend_fwd(*_common_args(pair_data, tile_start, tile_count, plan, grid_x, tile_base), width, height,
                        channels, bits.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "blend_fwd")
    profiling.count("blend_fwd")
    return out, (plan, bits)


def blend_fwd_cuda(pair_data, tile_start, tile_count, grid_x, width, height, channels, tile_base=0):
    """blend_fwd_split's raw state alone."""
    return blend_fwd_split(pair_data, tile_start, tile_count, grid_x, width, height, channels, tile_base)[0]


def blend_bwd_cuda(pair_data, tile_start, tile_count, grid_x, width, height, channels, fwd, dout, split,
                   tile_base=0):
    """Launch csrc/blend_bwd.cu: each tile's chain states at its segment
    boundaries, then one block per (tile, segment) -> [F, P]. `split` is
    blend_fwd_split's of the same inputs. The arguments are blend_bwd_plain's
    and `split`; the image's width and height are not read, since the
    forward's bits and n_contrib already leave out pixels outside it."""
    _check_cuda(pair_data, tile_start, tile_count, channels, fwd, dout)
    lib = _build.load("blend_bwd", {"blend_bwd": _BWD_ARGS})
    dev = pair_data.device
    plan, bits = split
    states = torch.empty((max(plan.states, 1), 2 + 2 * channels, PIX), dtype=torch.float32, device=dev)
    grads = torch.zeros_like(pair_data)
    err = lib.blend_bwd(*_common_args(pair_data, tile_start, tile_count, plan, grid_x, tile_base), channels,
                        fwd.data_ptr(), dout.data_ptr(), bits.data_ptr(), states.data_ptr(),
                        grads.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "blend_bwd")
    profiling.count("blend_bwd")
    return grads


class BlendRaw(torch.autograd.Function):
    """Raw blend state [T, 8, 256], differentiable in pair_data only (the JAX
    package's blend_tiles_pallas_raw custom VJP). Cotangents of rows 4, 5
    and 7 are structurally zero and never read."""

    @staticmethod
    def forward(ctx, pair_data, tile_start, tile_count, grid_x, width, height, channels, tile_base):
        ctx.split = None
        args = (pair_data, tile_start, tile_count, grid_x, width, height, channels)
        with profiling.span("render.blend_fwd"):
            if pair_data.is_cuda:
                raw, ctx.split = blend_fwd_split(*args, tile_base)
            else:
                raw = blend_fwd_plain(*args, tile_base)
        ctx.save_for_backward(pair_data, tile_start, tile_count, raw)
        ctx.meta = (grid_x, width, height, channels)
        ctx.tile_base = tile_base
        return raw

    @staticmethod
    def backward(ctx, ct):
        pair_data, tile_start, tile_count, raw = ctx.saved_tensors
        with profiling.span("render.blend_bwd"):
            args = (pair_data, tile_start, tile_count, *ctx.meta, raw, ct.contiguous())
            if pair_data.is_cuda:
                grads = blend_bwd_cuda(*args, split=ctx.split, tile_base=ctx.tile_base)
            else:
                grads = blend_bwd_plain(*args, tile_base=ctx.tile_base)
        return grads, None, None, None, None, None, None, None


def blend_raw(pair_data, tile_start, tile_count, grid_x: int, width: int, height: int, channels: int,
              tile_base: int = 0):
    return BlendRaw.apply(pair_data, tile_start, tile_count, grid_x, width, height, channels, tile_base)
