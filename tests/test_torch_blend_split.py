"""The split blend kernels' Python side on the CPU: the (tile, segment) work
list that sizes their grids and scratch (`split_plan`), and a test-local
emulation of the split backward (segment states from a back-to-front scan,
then a walk of each segment from its recorded state), held per pixel
against the plain version's walk."""

import numpy as np
import pytest
import torch

from gaustar_tpu_torch.cameras import Camera
from gaustar_tpu_torch.ops import blend_cuda as bc
from gaustar_tpu_torch.ops.projection import quat_scale_to_cov3d
from gaustar_tpu_torch.utils.synthetic import blend_inputs

S = bc.SEG


def _segments(c, seg):
    return -(-c // seg)


def _reference_plan(counts, seg):
    """Per tile (segments, words, states) by a Python loop."""
    return [(_segments(c, seg), _segments(c, bc.WORD), max(_segments(c, seg) - 1, 0)) for c in counts]


def _item_tiles(plan, n_items):
    """The kernels' item -> tile search (first tile whose segment end exceeds
    the item), as torch.searchsorted."""
    return torch.searchsorted(plan.ends[0], torch.arange(n_items, dtype=torch.int32), right=True)


@pytest.mark.parametrize("counts", [
    [0, 1, S - 1, S, S + 1, 0, 16008, 2 * S],  # ragged ends, exact multiples, one long list
    [S],  # a single tile of exactly one segment
    [0, 0, 0],  # nothing to do
    [0, 3 * S + 7, 0, 0, 1],  # empty tiles around a long one
])
def test_split_plan_counts_and_offsets(counts):
    count = torch.tensor(counts, dtype=torch.int32)
    plan = bc.split_plan(count, sum(counts))
    ref = np.array(_reference_plan(counts, S), dtype=np.int64).reshape(-1, 3)
    assert plan.ends.dtype == torch.int32 and plan.ends.shape == (3, len(counts))
    np.testing.assert_array_equal(plan.ends.numpy(), np.cumsum(ref, axis=0).T)
    n_items, n_words, n_states = ref.sum(axis=0)
    assert n_items <= plan.items and n_words <= plan.words and n_states <= plan.states
    assert plan.bits_bytes() == 4 * 256 * plan.words
    assert plan.state_bytes(4) == 4 * 256 * 10 * plan.states


def test_split_plan_exact_segment_and_one_more():
    plan = bc.split_plan(torch.tensor([S, S + 1], dtype=torch.int32), 2 * S + 1)
    # a tile of exactly S pairs is one item, 8 words and no recorded state;
    # one pair more is two items, 9 words and one state.
    assert plan.ends.tolist() == [[1, 3], [S // 32, S // 32 + S // 32 + 1], [0, 1]]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_split_plan_items_cover_every_segment_once(seed):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 3 * S, size=200) * (rng.uniform(size=200) < 0.6)
    counts[rng.integers(0, 200)] = 16008
    num_pairs = int(counts.sum()) + int(rng.integers(0, 50))  # the pair buffer may be longer
    plan = bc.split_plan(torch.as_tensor(counts, dtype=torch.int32), num_pairs)
    tiles = _item_tiles(plan, plan.items)
    seg_start = plan.ends[0] - torch.as_tensor(_segments(counts, S), dtype=torch.int32)
    got = [(int(t), i - int(seg_start[t])) for i, t in enumerate(tiles.tolist()) if t < len(counts)]
    want = [(t, s) for t, c in enumerate(counts) for s in range(_segments(int(c), S))]
    assert got == want
    assert all(int(t) == len(counts) for t in tiles[len(want):])  # items past the last exit
    # words and states of different tiles never overlap and fit the scratch
    for row, per_tile, cap in ((1, _segments(counts, bc.WORD), plan.words),
                               (2, np.maximum(_segments(counts, S) - 1, 0), plan.states)):
        end = plan.ends[row].numpy().astype(np.int64)
        start = end - per_tile
        assert (start >= 0).all() and end[-1] <= cap
        np.testing.assert_array_equal(start[1:], end[:-1])


# ---------------------------------------------------------------------------
# The split backward, emulated in PyTorch with small segments
# ---------------------------------------------------------------------------

EMU_SEG = 8


def _split_backward_per_pixel(pair_data, tile_start, tile_count, grid_x, width, height, channels, fwd, dout,
                              seg=EMU_SEG):
    """Per-pixel gradient contributions [6 + C, P, 256] of the split
    backward: phase A scans each tile back to front over its included pairs
    and records the chain state (T, last alpha, suffix colour sums, last
    colours) at every segment boundary; phase B walks each (tile, segment)
    item back to front from its recorded state. The per-step arithmetic is
    blend_bwd_plain's."""
    n_fields = 6 + channels
    plan = bc.split_plan(tile_count, pair_data.shape[1], seg)
    ids, start, count = bc._active_tiles(tile_start, tile_count)
    px, py = bc._tile_pixels(ids, grid_x)
    t_final, nc, d_t = fwd[ids, 3], fwd[ids, 4], dout[ids, 3]
    d_c = [dout[ids, bc.state_row(ch)] for ch in range(channels)]
    zero = torch.zeros_like(px)
    nseg = (count + seg - 1) // seg
    state_start = plan.ends[2][ids].long() - (nseg - 1)

    def included(k, start_, count_, px_, py_, nc_):
        d, valid = bc._pair_at(pair_data, start_, count_, k)
        alpha, contrib, g, dx, dy = bc._eval_pair(d, px_, py_)
        return d, alpha, g, dx, dy, valid, contrib & valid[:, None] & (nc_ >= k + 1)

    # Phase A: record (T, last_alpha, acc, last_c) at the back end of segment
    # s - 1 once segment s is walked, for s = nseg - 1 .. 1.
    states = torch.zeros((max(plan.states, 1), 2 + 2 * channels, 256))
    T, last_alpha = t_final.clone(), zero
    acc, last_c = [zero] * channels, [zero] * channels
    for k in range(int(count.max()) - 1, -1, -1):
        d, alpha, _, _, _, _, inc = included(k, start, count, px, py, nc)
        T = torch.where(inc, T / (1.0 - alpha), T)
        for ch in range(channels):
            acc[ch] = torch.where(inc, last_alpha * last_c[ch] + (1.0 - last_alpha) * acc[ch], acc[ch])
            last_c[ch] = torch.where(inc, d[6 + ch][:, None].expand_as(zero), last_c[ch])
        last_alpha = torch.where(inc, alpha, last_alpha)
        if k % seg == 0 and k > 0:
            rec = (k < count).nonzero().flatten()
            states[state_start[rec] + k // seg - 1] = torch.stack([T, last_alpha, *acc, *last_c], 1)[rec]

    # Phase B: every item from its own start state, independent of the others.
    item_tile = _item_tiles(plan, plan.items)
    item_tile = item_tile[item_tile < tile_count.shape[0]].long()
    row = torch.searchsorted(ids, item_tile)  # the item's tile among the active ones
    seg_of = torch.arange(item_tile.numel()) - (plan.ends[0][item_tile].long() - nseg[row])
    last_seg = seg_of == nseg[row] - 1
    st = states[torch.where(last_seg, 0, state_start[row] + seg_of)]
    T = torch.where(last_seg[:, None], t_final[row], st[:, 0])
    last_alpha = torch.where(last_seg[:, None], zero[row], st[:, 1])
    acc = [torch.where(last_seg[:, None], zero[row], st[:, 2 + ch]) for ch in range(channels)]
    last_c = [torch.where(last_seg[:, None], zero[row], st[:, 2 + channels + ch]) for ch in range(channels)]
    i_start, i_count = start[row] + seg_of * seg, torch.clamp(count[row] - seg_of * seg, max=seg)
    i_nc = nc[row] - (seg_of * seg)[:, None]  # n_contrib counted from the segment's first pair
    i_px, i_py, i_tf, i_dt = px[row], py[row], t_final[row], d_t[row]
    i_dc = [c[row] for c in d_c]
    i_zero = torch.zeros_like(i_px)
    out = torch.zeros((n_fields, pair_data.shape[1], 256))
    for j in range(seg - 1, -1, -1):
        d, alpha, g, dx, dy, valid, inc = included(j, i_start, i_count, i_px, i_py, i_nc)
        T = torch.where(inc, T / (1.0 - alpha), T)
        w = alpha * T
        dl_da = i_zero
        g_feat = []
        for ch in range(channels):
            c = d[6 + ch][:, None]
            acc[ch] = torch.where(inc, last_alpha * last_c[ch] + (1.0 - last_alpha) * acc[ch], acc[ch])
            last_c[ch] = torch.where(inc, c.expand_as(i_zero), last_c[ch])
            dl_da = dl_da + (c - acc[ch]) * i_dc[ch]
            g_feat.append(torch.where(inc, w * i_dc[ch], i_zero))
        dl_da = dl_da * T
        last_alpha = torch.where(inc, alpha, last_alpha)
        dl_da = dl_da + (-i_tf / (1.0 - alpha)) * i_dt
        q = torch.where(inc, g * dl_da, i_zero)
        A, B, C = d[2][:, None], d[3][:, None], d[4][:, None]
        op = d[5][:, None]
        per_pixel = [-op * q * (A * dx + B * dy), -op * q * (C * dy + B * dx), -0.5 * op * q * dx * dx,
                     -op * q * dx * dy, -0.5 * op * q * dy * dy, q] + g_feat
        out[:, (i_start + j)[valid]] = torch.stack(per_pixel, 0)[:, valid]
    return out


def _scene(channels, seed=0, n=80, width=40, height=28):
    """A 3 x 2 tile image whose bottom tile row is cut (pixels outside), an
    opaque front for sticky stops, and lists that span many segments."""
    rng = np.random.default_rng(seed)
    means = np.concatenate([rng.normal(scale=0.3, size=(n, 2)), 4.0 + rng.uniform(0, 2, (n, 1))], 1)
    scales = np.exp(rng.normal(-2.2, 0.4, (n, 3)))
    quats = rng.normal(size=(n, 4))
    opac = 1 / (1 + np.exp(-rng.normal(size=n)))
    opac[: n // 5] = 0.995
    feats = rng.uniform(size=(n, channels))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    cam = Camera.from_w2c(np.eye(4), 50.0, 50.0, width / 2, height / 2, width, height, device="cpu")
    pd, start, count, gx, w, h = blend_inputs(t(means), quat_scale_to_cov3d(t(scales), t(quats)), t(opac),
                                              t(feats), cam, channels)
    fwd = bc.blend_fwd_plain(pd, start, count, gx, w, h, channels)
    dout = torch.zeros_like(fwd)
    gen = torch.Generator().manual_seed(seed + 11)
    for r in (0, 1, 2, 3, 6):
        dout[:, r] = torch.randn(dout[:, r].shape, generator=gen)
    return (pd, start, count, gx, w, h, channels), fwd, dout


@pytest.mark.parametrize("channels", [3, 4])
def test_split_backward_equals_plain_walk_per_pixel(channels):
    args, fwd, dout = _scene(channels)
    count = args[2]
    assert int((count > 0).sum()) >= 4 and int(count.max()) > 4 * EMU_SEG  # many segments per list
    assert (fwd[:, 5][count > 0] > 0).any()  # some pixels stopped
    per_pixel = _split_backward_per_pixel(*args, fwd, dout)
    assert per_pixel.abs().max() > 0
    # The plain walk's contribution of pixel p: its cotangent alone, so each
    # slot's 256-pixel sum adds zeros to pixel p's value.
    for p in range(0, 256, 3):
        mask = torch.zeros(256)
        mask[p] = 1.0
        ref = bc.blend_bwd_plain(*args, fwd, dout * mask)
        assert torch.equal(per_pixel[..., p], ref[: 6 + channels]), f"pixel {p}"
    total = bc.blend_bwd_plain(*args, fwd, dout)[: 6 + channels]
    torch.testing.assert_close(per_pixel.sum(-1), total, rtol=1e-6, atol=1e-6 * float(total.abs().max()))
