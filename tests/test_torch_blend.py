"""Port blend (plain PyTorch versions of the CUDA kernels) and rasterizer vs
the JAX package: the Pallas kernels in interpret mode, the golden fixtures,
autograd, and the fused 4-channel render."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gaustar_tpu.cameras import Camera as JCamera
from gaustar_tpu.ops import binning as jbin
from gaustar_tpu.ops import projection as jproj
from gaustar_tpu.ops.blend_pallas import blend_tiles_pallas_raw
from gaustar_tpu_torch.cameras import Camera
from gaustar_tpu_torch.ops.blend_cuda import blend_bwd_plain, blend_fwd_plain, blend_raw
from gaustar_tpu_torch.ops.projection import quat_scale_to_cov3d
from gaustar_tpu_torch.ops.rasterizer import RasterConfig, assemble_image_cm, rasterize
from gaustar_tpu_torch.utils.synthetic import blend_inputs

GOLDEN = sorted(glob.glob(os.path.join(os.path.dirname(__file__), "golden", "*.npz")))
W = H = 32
CHUNK = 32
# Image / final T tolerance of tests/test_golden.py: the two packages blend in
# float32 with products taken in another order (the Pallas kernel's chunk
# scans against the port's sequential walk).
TOL = 3e-5


def _grad_close(a, b, name):
    # Gradient tolerance of tests/test_golden.py: rtol 2e-3, absolute floor
    # max(2e-4, 1% of the reference's inf-norm); the Pallas backward's
    # log-space suffix products and moment sums round differently.
    atol = max(2e-4, 1e-2 * float(np.abs(b).max()))
    np.testing.assert_allclose(a, b, rtol=2e-3, atol=atol, err_msg=name)


def _scene(n, seed, channels):
    rng = np.random.default_rng(seed)
    means = np.concatenate(
        [rng.normal(scale=0.35, size=(n, 2)), 4.0 + rng.uniform(0, 2, size=(n, 1))], axis=1
    ).astype(np.float32)
    scales = np.exp(rng.normal(loc=-2.2, scale=0.4, size=(n, 3))).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    opac = (1.0 / (1.0 + np.exp(-rng.normal(size=(n,))))).astype(np.float32)
    opac[: n // 4] = 0.995  # opaque front: sticky stops and the 0.99 clamp
    colors = rng.uniform(size=(n, channels)).astype(np.float32)
    return means, scales, quats, opac, colors


@pytest.fixture(scope="module", params=[3, 4], ids=["c3", "c4"])
def pallas_case(request):
    """JAX-binned pair data, the Pallas raw state (interpret mode) and its
    VJP for a seeded cotangent on rows 0-3 and 6."""
    channels = request.param
    m, s, q, o, c = _scene(60, seed=channels, channels=channels)
    cam = JCamera.from_w2c(np.eye(4), 60.0, 60.0, W / 2.0, H / 2.0, W, H)
    g = jproj.preprocess(jnp.asarray(m), jproj.quat_scale_to_cov3d(jnp.asarray(s), jnp.asarray(q)),
                         jnp.asarray(o), jnp.asarray(c), cam)
    gx = gy = W // 16
    b = jbin.bin_gaussians(g, gx, gy, max_pairs=1 << 12, chunk=CHUNK)
    pair_data = jbin.gather_pair_data(g, b)
    ids = jnp.arange(gx * gy, dtype=jnp.int32)

    def raw_fn(pd):
        return blend_tiles_pallas_raw(pd, b.tile_start, b.tile_nchunks, jnp.zeros((1,), jnp.int32),
                                      ids, gx, gy, W, H, CHUNK, channels, True)

    raw, vjp = jax.vjp(raw_fn, pair_data)
    rng = np.random.default_rng(100 + channels)
    ct = np.zeros(raw.shape, np.float32)
    for row in (0, 1, 2, 3, 6):
        ct[:, row] = rng.normal(size=ct[:, row].shape)
    (grads,) = vjp(jnp.asarray(ct))
    return dict(
        channels=channels, gx=gx,
        pair_data=torch.as_tensor(np.array(pair_data)),
        tile_start=torch.as_tensor(np.asarray(b.tile_start, np.int32)),
        tile_count=torch.as_tensor(np.asarray(b.tile_count, np.int32)),
        raw=np.asarray(raw), ct=torch.as_tensor(ct), grads=np.asarray(grads),
    )


def test_plain_forward_matches_pallas(pallas_case):
    k = pallas_case
    raw = blend_fwd_plain(k["pair_data"], k["tile_start"], k["tile_count"], k["gx"], W, H,
                          k["channels"]).numpy()
    ref = k["raw"]
    assert (ref[:, 4] > 0).any() and (ref[:, 5] > 0).any()
    for row in (0, 1, 2, 3, 6, 7):
        np.testing.assert_allclose(raw[:, row], ref[:, row], atol=TOL, err_msg=f"row {row}")
    np.testing.assert_array_equal(raw[:, 4], ref[:, 4])  # n_contrib
    np.testing.assert_array_equal(raw[:, 5], ref[:, 5])  # done


def test_plain_backward_matches_pallas(pallas_case):
    k = pallas_case
    args = (k["pair_data"], k["tile_start"], k["tile_count"], k["gx"], W, H, k["channels"])
    raw = blend_fwd_plain(*args)
    grads = blend_bwd_plain(*args, raw, k["ct"]).numpy()
    ref = k["grads"]
    assert np.abs(ref[:6 + k["channels"]]).max() > 0
    for row in range(ref.shape[0]):
        _grad_close(grads[row], ref[row], f"field {row}")


def test_plain_backward_is_autograd_of_plain_forward(pallas_case):
    k = pallas_case
    pd = k["pair_data"].clone().requires_grad_()
    args = (k["tile_start"], k["tile_count"], k["gx"], W, H, k["channels"])
    raw = blend_fwd_plain(pd, *args)
    (raw * k["ct"]).sum().backward()
    grads = blend_bwd_plain(k["pair_data"], *args, raw.detach(), k["ct"])
    ref = pd.grad.numpy()
    for row in range(ref.shape[0]):
        np.testing.assert_allclose(grads[row].numpy(), ref[row], rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(ref[row]).max()), err_msg=f"field {row}")


def test_blend_raw_autograd_function(pallas_case):
    k = pallas_case
    pd = k["pair_data"].clone().requires_grad_()
    raw = blend_raw(pd, k["tile_start"], k["tile_count"], k["gx"], W, H, k["channels"])
    (raw * k["ct"]).sum().backward()
    for row in range(pd.shape[0]):
        _grad_close(pd.grad[row].numpy(), k["grads"][row], f"field {row}")


@pytest.mark.parametrize("path", GOLDEN, ids=[os.path.basename(p)[:-4] for p in GOLDEN])
def test_golden_fixture_through_port(path):
    z = np.load(path)
    cam = Camera.from_w2c(z["w2c"], float(z["fx"]), float(z["fy"]), float(z["cx"]), float(z["cy"]),
                          int(z["width"]), int(z["height"]), device="cpu")
    leaves = [torch.tensor(z[k], requires_grad=True)
              for k in ("means3d", "scales", "quats", "opacities", "colors")]
    m, s, q, o, c = leaves
    img, aux = rasterize(m, quat_scale_to_cov3d(s, q), o, c, cam, bg=tuple(z["bg"]))
    loss = (img * torch.as_tensor(z["probe"])).sum() + (aux.final_T * torch.as_tensor(z["probe_t"])).sum()
    loss.backward()
    np.testing.assert_allclose(img.detach().numpy(), z["image"], atol=TOL, err_msg="image")
    np.testing.assert_allclose(aux.final_T.detach().numpy(), z["final_T"], atol=TOL, err_msg="final_T")
    np.testing.assert_array_equal(aux.n_contrib.numpy(), z["n_contrib"])
    for key, leaf in zip(("g_means3d", "g_scales", "g_quats", "g_opacities", "g_colors"), leaves):
        _grad_close(leaf.grad.numpy(), z[key], key)


def test_means2d_dummy_gradient_and_cm_layout_match_jax():
    """dL/d(NDC mean2d) through the zero `means2d_dummy` input, with the
    channels-major image, against the JAX package's tiled path."""
    from gaustar_tpu.ops.rasterizer import RasterConfig as JRasterConfig, rasterize as jrasterize

    m, s, q, o, c = _scene(60, seed=5, channels=3)
    args = (np.eye(4), 60.0, 60.0, 20.0, 18.0, 40, 36)
    jcam, tcam = JCamera.from_w2c(*args), Camera.from_w2c(*args, device="cpu")
    probe = np.random.default_rng(6).normal(size=(3, 36, 40)).astype(np.float32)
    jcfg = JRasterConfig(max_pairs=1 << 14, chunk=32, max_per_tile=512, impl="jax")

    def jloss(dummy):
        img, _ = jrasterize(jnp.asarray(m), jproj.quat_scale_to_cov3d(jnp.asarray(s), jnp.asarray(q)),
                            jnp.asarray(o), jnp.asarray(c), jcam, config=jcfg, means2d_dummy=dummy, layout="cm")
        return (img * probe).sum(), img

    (_, jimg), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.zeros((60, 2), jnp.float32))
    dummy = torch.zeros((60, 2), requires_grad=True)
    img, _ = rasterize(torch.as_tensor(m), quat_scale_to_cov3d(torch.as_tensor(s), torch.as_tensor(q)),
                       torch.as_tensor(o), torch.as_tensor(c), tcam, means2d_dummy=dummy, layout="cm")
    (img * torch.as_tensor(probe)).sum().backward()
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(jimg), atol=TOL)
    assert np.abs(np.asarray(jg)).max() > 0
    _grad_close(dummy.grad.numpy(), np.asarray(jg), "means2d_dummy")


def test_fused_four_channels_equal_two_passes():
    m, s, q, o, c4 = _scene(50, seed=7, channels=4)
    cam = Camera.from_w2c(np.eye(4), 60.0, 60.0, 24.0, 16.0, 48, 32, device="cpu")
    probe = torch.as_tensor(np.random.default_rng(8).normal(size=(32, 48, 4)).astype(np.float32))

    def run(channels_split):
        leaves = [torch.tensor(a, requires_grad=True) for a in (m, s, q, o, c4)]
        cov = quat_scale_to_cov3d(leaves[1], leaves[2])
        bg = (0.1, 0.2, 0.3, 10.0)
        if channels_split:
            rgb, _ = rasterize(leaves[0], cov, leaves[3], leaves[4][:, :3], cam, bg=bg[:3])
            dep, _ = rasterize(leaves[0], cov, leaves[3], leaves[4][:, 3:].expand(-1, 3), cam, bg=(bg[3],) * 3)
            img = torch.cat([rgb, dep[..., :1]], dim=-1)
        else:
            img, _ = rasterize(leaves[0], cov, leaves[3], leaves[4], cam, bg=bg,
                               config=RasterConfig(channels=4))
        (img * probe).sum().backward()
        return img.detach().numpy(), [x.grad.numpy() for x in leaves]

    img2, g2 = run(True)
    img4, g4 = run(False)
    np.testing.assert_allclose(img4, img2, atol=1e-6)
    for a, b in zip(g4, g2):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(b).max()))


def test_blend_inputs_are_the_rasterizers():
    m, s, q, o, c4 = (torch.as_tensor(a) for a in _scene(50, seed=7, channels=4))
    cam = Camera.from_w2c(np.eye(4), 60.0, 60.0, 24.0, 16.0, 48, 32, device="cpu")
    cov = quat_scale_to_cov3d(s, q)
    pd, start, count, gx, w, h = blend_inputs(m, cov, o, c4, cam, 4)
    maps = assemble_image_cm(blend_fwd_plain(pd, start, count, gx, w, h, 4), gx, -(-h // 16), w, h)
    with torch.no_grad():
        img, aux = rasterize(m, cov, o, c4, cam, bg=(0.0,) * 4, config=RasterConfig(channels=4), layout="cm")
    torch.testing.assert_close(maps[[0, 1, 2, 6]], img, rtol=0, atol=0)
    assert pd.shape[1] == aux.num_pairs
    top = blend_inputs(m, cov, o, c4, cam, 4, top_tiles=2)[2]
    assert int((top > 0).sum()) == 2 and torch.equal(top.max(), count.max())
