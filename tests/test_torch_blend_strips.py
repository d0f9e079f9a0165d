"""The blend's tile_base offset: a strip of an image blends on its own.

The plain versions (what the CPU runs in place of the CUDA kernels) over
strips of ceil(T / D) tiles, each with its first tile as tile_base and the
last padded with empty tiles, concatenate to the full grid's result exactly;
one strip is held against the JAX package's Pallas kernels (interpret mode)
at the same tile_base."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu.cameras import Camera as JCamera
from gaustar_tpu.ops import binning as jbin
from gaustar_tpu.ops import projection as jproj
from gaustar_tpu.ops.blend_pallas import blend_tiles_pallas_base, blend_tiles_pallas_raw
from gaustar_tpu_torch.ops.blend_cuda import blend_bwd_plain, blend_fwd_plain, blend_raw
from gaustar_tpu_torch.ops.projection import quat_scale_to_cov3d
from gaustar_tpu_torch.utils.synthetic import blend_inputs, ring_cameras
from port_helpers import one_thread  # noqa: F401

W = H = 64  # 4 x 4 tiles: D = 3 leaves the last strip two tiles of padding
CHUNK = 32
# The golden tolerances of tests/test_golden.py, as tests/test_torch_blend.py
# holds the full grid to the Pallas kernels.
TOL = 3e-5


def _cloud(n, seed, channels):
    rng = np.random.default_rng(seed)
    means = np.concatenate(
        [rng.normal(scale=0.45, size=(n, 2)), 4.0 + rng.uniform(0, 2, size=(n, 1))], axis=1
    ).astype(np.float32)
    scales = np.exp(rng.normal(loc=-2.4, scale=0.4, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = (1.0 / (1.0 + np.exp(-rng.normal(size=(n,))))).astype(np.float32)
    opac[: n // 4] = 0.995
    colors = rng.uniform(size=(n, channels)).astype(np.float32)
    return means, scales, quats, opac, colors


def _strip(tile_start, tile_count, d, g):
    """(start, count, tile_base) of strip g of d: tiles [g tpd, (g + 1) tpd),
    the tail past the grid padded with empty tiles."""
    n = tile_start.shape[0]
    tpd = -(-n // d)
    t0, t1 = min(g * tpd, n), min((g + 1) * tpd, n)
    start = torch.zeros(tpd, dtype=torch.int32)
    count = torch.zeros(tpd, dtype=torch.int32)
    start[: t1 - t0] = tile_start[t0:t1]
    count[: t1 - t0] = tile_count[t0:t1]
    return start, count, g * tpd


@pytest.fixture(scope="module", params=[3, 4], ids=["c3", "c4"])
def port_case(request):
    channels = request.param
    m, s, q, o, c = (torch.as_tensor(a) for a in _cloud(300, seed=10 + channels, channels=channels))
    cam = ring_cameras(1, w=W, h=H, focal=80.0, device="cpu")[0]
    pd, start, count, gx, w, h = blend_inputs(m, quat_scale_to_cov3d(s, q), o, c, cam, channels)
    ct = torch.zeros((start.shape[0], 8, 256))
    gen = torch.Generator().manual_seed(channels)
    for row in (0, 1, 2, 3, 6):
        ct[:, row] = torch.randn(ct[:, row].shape, generator=gen)
    raw = blend_fwd_plain(pd, start, count, gx, w, h, channels)
    grads = blend_bwd_plain(pd, start, count, gx, w, h, channels, raw, ct)
    assert (count > 0).sum() >= 12 and (raw[:, 5] > 0).any()
    return dict(channels=channels, pd=pd, start=start, count=count, gx=gx, raw=raw, ct=ct, grads=grads)


@pytest.mark.parametrize("d", [2, 3])
def test_plain_strips_concatenate_to_full_grid(port_case, d):
    k = port_case
    n_tiles = k["start"].shape[0]
    raws, grads = [], torch.zeros_like(k["grads"])
    for g in range(d):
        start, count, base = _strip(k["start"], k["count"], d, g)
        args = (k["pd"], start, count, k["gx"], W, H, k["channels"])
        raw = blend_fwd_plain(*args, tile_base=base)
        ct = torch.zeros_like(raw)
        live = min(n_tiles - base, raw.shape[0])
        ct[:live] = k["ct"][base:base + live]
        grads += blend_bwd_plain(*args, raw, ct, tile_base=base)
        raws.append(raw)
    full = torch.cat(raws)
    assert torch.equal(full[n_tiles:, 3], torch.ones_like(full[n_tiles:, 3]))  # the padding is empty
    assert torch.equal(full[:n_tiles], k["raw"])
    assert torch.equal(grads, k["grads"])


def test_blend_raw_backward_takes_the_offset(port_case):
    k = port_case
    start, count, base = _strip(k["start"], k["count"], 3, 1)
    pd = k["pd"].clone().requires_grad_()
    raw = blend_raw(pd, start, count, k["gx"], W, H, k["channels"], tile_base=base)
    ct = k["ct"][base:base + start.shape[0]]
    (raw * ct).sum().backward()
    ref = blend_bwd_plain(k["pd"], start, count, k["gx"], W, H, k["channels"], raw.detach(), ct, tile_base=base)
    assert torch.equal(pd.grad, ref)
    assert ref.abs().max() > 0


@pytest.mark.parametrize("channels", [3, 4], ids=["c3", "c4"])
def test_strip_matches_pallas_tile_base(channels):
    """Strip 1 of 3 (tiles 6-11) through the JAX package's
    blend_tiles_pallas_base and through the port's plain versions."""
    m, s, q, o, c = _cloud(300, seed=20 + channels, channels=channels)
    cam = JCamera.from_w2c(np.eye(4), 80.0, 80.0, W / 2.0, H / 2.0, W, H)
    g = jproj.preprocess(jnp.asarray(m), jproj.quat_scale_to_cov3d(jnp.asarray(s), jnp.asarray(q)),
                         jnp.asarray(o), jnp.asarray(c), cam)
    gx = gy = W // 16
    b = jbin.bin_gaussians(g, gx, gy, max_pairs=1 << 13, chunk=CHUNK)
    pair_data = jbin.gather_pair_data(g, b)
    start, count, base = _strip(torch.as_tensor(np.array(b.tile_start, np.int32)),
                                torch.as_tensor(np.array(b.tile_count, np.int32)), 3, 1)
    nch = jnp.asarray(np.asarray(b.tile_nchunks)[base:base + start.shape[0]])
    ids = jnp.arange(start.shape[0], dtype=jnp.int32)
    tb = jnp.asarray([base], jnp.int32)

    def raw_fn(pd):
        return blend_tiles_pallas_raw(pd, jnp.asarray(start.numpy()), nch, tb, ids, gx, gy, W, H, CHUNK,
                                      channels, True)

    ref, vjp = jax.vjp(raw_fn, pair_data)
    ref = np.asarray(ref)
    color, final_t, n_contrib = blend_tiles_pallas_base(pair_data, jnp.asarray(start.numpy()), nch, tb, gx, gy, W,
                                                        H, CHUNK, channels, True)
    np.testing.assert_array_equal(np.asarray(final_t), ref[:, 3])
    np.testing.assert_array_equal(np.asarray(n_contrib), ref[:, 4])

    pd = torch.as_tensor(np.array(pair_data))
    args = (pd, start, count, gx, W, H, channels)
    raw = blend_fwd_plain(*args, tile_base=base).numpy()
    assert (ref[:, 4] > 0).any() and (ref[:, 5] > 0).any()
    for row in (0, 1, 2, 3, 6, 7):
        np.testing.assert_allclose(raw[:, row], ref[:, row], atol=TOL, err_msg=f"row {row}")
    np.testing.assert_array_equal(raw[:, 4], ref[:, 4])
    np.testing.assert_array_equal(raw[:, 5], ref[:, 5])

    rng = np.random.default_rng(200 + channels)
    ct = np.zeros(ref.shape, np.float32)
    for row in (0, 1, 2, 3, 6):
        ct[:, row] = rng.normal(size=ct[:, row].shape)
    (g_ref,) = vjp(jnp.asarray(ct))
    g_ref = np.asarray(g_ref)
    grads = blend_bwd_plain(*args, torch.as_tensor(raw), torch.as_tensor(ct), tile_base=base).numpy()
    assert np.abs(g_ref[:6 + channels]).max() > 0
    for row in range(g_ref.shape[0]):
        # Gradient tolerance of tests/test_golden.py (tests/test_torch_blend.py).
        atol = max(2e-4, 1e-2 * float(np.abs(g_ref[row]).max()))
        np.testing.assert_allclose(grads[row], g_ref[row], rtol=2e-3, atol=atol, err_msg=f"field {row}")
